// K1: fused u8 IQ -> (x - 128) -> K-tap decimate-by-f (exact int32) ->
// FM demod (polynomial atan2 of x[m] * conj(x[m-1])).
//
// Replaces the TPU kernel sdr_tpu/kernels/u8_front_demod_pallas.py:
// u8_front_demod_pallas (pl.pallas_call at :112, body _demod_kernel :73).
//
// Bound on an H100: memory.  On the FM chain's block-parallel batch
// (32 rows of 10,485,760 u8 bytes, K = 51, f = 8) it reads 335.5 MB and
// writes 84 MB: about 0.125 ms at 3.35 TB/s.  The integer work, 2 * K
// multiply-adds per output and plane, is far below the card's rate.
//
// Design (the deinterleave's byte arithmetic and the sums are K4's too:
// u8_window.cuh, whose note counts the shared-memory banks):
// * Tiles of 8 (W - 1) consecutive outputs of one row (W = 128 at the
//   paths' sizes: 1,016 outputs), walked by persistent blocks, three an
//   SM (at most 72 registers a thread).
//   A block is eight consumer warps and one producer warp around a ring
//   of S slots in shared memory, each slot one tile's stream bytes, with
//   a full and an empty mbarrier a slot.
// * The producer warp keeps up to S tiles' bytes in flight.  For each of
//   its block's tiles in turn it waits for the slot's release; then one
//   lane asks the TMA for the span's 16-byte chunks that lie wholly in
//   the block tensor x as one bulk copy (cp.async.bulk, completing its
//   bytes on the slot's full barrier), while the other lanes write byte
//   by byte the chunks that hold history bytes or cross the tensor's ends
//   (only a row's first tile and the tensor's last need them).  Every
//   lane arrives on the full barrier; its phase completes when the bulk
//   copy's bytes have landed too.
// * Each consumer warp takes W consecutive samples of every tile, the
//   first the predecessor of its W - 1 outputs (computed like the others;
//   the first of a row's first tile is the carry last_iq).  It waits on
//   the full barrier, reads the tile's row, first output, byte offset and
//   length from the head the producer wrote beside the slot,
//   deinterleaves its stretch of the slot into its own s8 I and Q planes
//   (each byte ^ 0x80), releases the slot (one arrival a warp on the
//   empty barrier), sums its samples with __dp4a, the tap words in
//   registers (26 dp4a a sample for 51 s8 taps), lane l the
//   samples l + 32 j, takes each output's predecessor from the lane
//   before by a shuffle, and demodulates and stores.  No barrier spans
//   the block: the warps drift apart as far as the ring lets them.
// * The plan (`plan`, mirrored by kernels/u8_front_demod.py:ring_plan):
//   W the largest of 128, 64, 32 samples whose ring of kMinStages slots
//   or more fits three blocks an SM, S as many slots as fit, up to
//   kMaxStages (3 at the FM front's 51 taps, f = 8).  A geometry that no
//   such ring fits takes W = 32 and one block an SM.  Smaller tiles do
//   not speed a short launch: the streamed block took 0.0069 ms at
//   W = 32 and 0.0056 at W = 128 (H100, 700 W, two blocks an SM).
// * A row's stream is concat(hist, x): byte p < H comes from the row's
//   H-byte history, the rest from its block.  Reading through the two
//   pointers covers every output; no concatenated copy is ever made.
// * The TPU kernel passes the previous tile's last sample through VMEM
//   scratch, because its grid runs in order.  CUDA blocks and warps run
//   in no order, so each warp's stretch starts one sample early, as
//   above.
// * Every output is an independent int32 dot product, one f32 epilogue
//   multiply and the atan2 polynomial, each step one rounded operation
//   (no FMA contraction), so a sample does not depend on the tile or grid
//   that computed it and equals the plain PyTorch version bitwise.  No
//   atomics.
// * The lane that holds a row's last output writes its (I, Q) as the
//   row's next carry.
//
// What bounds it now (H100 SXM at 700 W, mono's [32, 10,485,760]): its
// consumer warps' instruction issue, not its bytes.  It takes 0.174 ms,
// 0.72 of the 0.125 ms its bytes need (the staged design it replaces,
// two cp.async buffers a block and four block-wide barriers a tile, took
// 0.239).  sdr_tpu_torch/kernel_variants.py: with no copies at all it
// still takes 0.172 ms; without the deinterleave 0.158, the demod 0.161,
// the sums 0.170 (they overlap the rest), the stores 0.173; the waits and
// heads alone 0.027.  Two blocks an SM take 0.189, four (56 registers a
// thread) 0.185; tiles of 64 samples a warp 0.209, of 256 in one slot
// 0.164; two slots take what three do.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "fm_demod.cuh"
#include "u8_window.cuh"

#ifndef DYNAMIC_SMEM
#define DYNAMIC_SMEM(name) extern __shared__ __align__(16) float name[]
#endif
#ifndef KERNEL_LAUNCH_SMEM
#define KERNEL_LAUNCH_SMEM(kernel, grid, block, smem, stream, ...) \
  kernel<<<grid, block, smem, stream>>>(__VA_ARGS__)
#endif

// The ring's synchronisation: mbarriers in shared memory, the TMA's bulk
// copy, and a consumer warp's own sync and shuffles.
namespace ring {

__device__ __forceinline__ unsigned sptr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(sptr(bar)),
               "r"(count)
               : "memory");
}

// the barriers' initialisation, visible before any thread uses them
__device__ __forceinline__ void fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::
          "r"(sptr(bar))
      : "memory");
}

// an arrival that also expects `bytes` of copies to complete on `bar`
__device__ __forceinline__ void arrive_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(sptr(bar)),
               "r"(bytes)
               : "memory");
}

// until the phase of parity `parity` of `bar` has completed
__device__ __forceinline__ void wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(sptr(bar)), "r"(parity)
        : "memory");
}

// `bytes` (a multiple of 16) from src to dst, both 16-byte aligned, by the
// TMA; the bytes complete on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(sptr(dst)),
      "l"(src), "r"(bytes), "r"(sptr(bar))
      : "memory");
}

// the generic proxy's writes to shared memory ordered before the TMA's
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a consumer warp's lanes: their shared-memory writes seen by each other
__device__ __forceinline__ void warp_sync() { __syncwarp(); }

// v of the lane before (lane 0: its own), and of lane 31
__device__ __forceinline__ float2 lane_before(float2 v) {
  return make_float2(__shfl_up_sync(0xffffffffu, v.x, 1),
                     __shfl_up_sync(0xffffffffu, v.y, 1));
}
__device__ __forceinline__ float2 lane_31(float2 v) {
  return make_float2(__shfl_sync(0xffffffffu, v.x, 31),
                     __shfl_sync(0xffffffffu, v.y, 31));
}

}  // namespace ring

namespace {

using u8w::NT;
using fmd::poly_atan2;   // fm_demod.cuh, shared with K11

constexpr int kThreads = NT + 32;   // the consumers, then the producer warp
constexpr int kWarps = NT / 32;     // consumer warps
constexpr int kBlocksPerSm = 3;
constexpr int kMinStages = 3, kMaxStages = 8;
constexpr int kMaxWarpSamples = 128;
constexpr int kPer = kMaxWarpSamples / 32;   // samples a lane
// a block's shared memory when kBlocksPerSm share an SM's 228 KB (each
// block also holds 1 KB the card reserves)
constexpr long long kBlockBytes = 229376 / kBlocksPerSm;
// the full and the empty barriers, then each slot's Head
constexpr long long kBarBytes = 48 * kMaxStages;

// A tile: each consumer warp's W samples, the first of them the
// predecessor of its W - 1 outputs, so kWarps (W - 1) outputs.
__host__ __device__ constexpr long long tile_outputs(long long W) {
  return kWarps * (W - 1);
}

// What the producer tells the consumers of the tile in a slot.
struct Head {
  long long row, m0;
  int off, nt;           // the span's offset in the slot; outputs
};

// A block's shared memory: the barriers and heads, S slots of a tile's
// stream bytes (u8w::raw_bytes: the alignment slack and the window; 32
// bytes more for the deinterleave's 16-byte reads past it), then each
// consumer warp's two planes.
struct Layout {
  long long slot, plane;
  int stages;
  __host__ __device__ Layout(long long W, int stages_, int f, int K, int nw)
      : slot(u8w::raw_bytes(tile_outputs(W) + 1, f, K) + 32),
        plane(u8w::plane_bytes(W, f, nw)),
        stages(stages_) {}
  __host__ __device__ long long slot_at(int s) const {
    return kBarBytes + s * slot;
  }
  __host__ __device__ long long planes_at(int w) const {
    return kBarBytes + stages * slot + 2 * w * plane;
  }
  __host__ __device__ long long total() const { return planes_at(kWarps); }
};

// slots of tiles of W samples a warp that fit `budget` bytes, at most
// kMaxStages
inline int stages_fit(long long W, int f, int K, int nw, long long budget) {
  const Layout none(W, 0, f, K, nw);
  const long long s = (budget - none.total()) / none.slot;
  return static_cast<int>(std::min<long long>(std::max(s, 0LL), kMaxStages));
}

__host__ __device__ inline long long tiles_per_row(long long num,
                                                   long long W) {
  return (num + tile_outputs(W) - 1) / tile_outputs(W);
}

struct Plan {
  long long W;      // samples a warp a tile (0: no ring fits)
  int stages;
  bool pair;        // kBlocksPerSm blocks an SM (else one)
  long long smem;   // bytes a block
};

// The ring a geometry takes: the largest W whose ring of kMinStages
// slots or more fits kBlockBytes, with as many slots as fit; else W = 32
// and one block an SM.
inline Plan plan(int f, int K, int nw) {
  Plan p{0, 0, true, 0};
  for (long long W = kMaxWarpSamples; W >= 32 && p.W == 0; W /= 2) {
    const int s = stages_fit(W, f, K, nw, kBlockBytes);
    if (s >= kMinStages) p = Plan{W, s, true, 0};
  }
  if (p.W == 0) {
    p = Plan{32, stages_fit(32, f, K, nw, u8w::MAX_SMEM), false, 0};
    if (p.stages == 0) p.W = 0;
  }
  if (p.W) p.smem = Layout(p.W, p.stages, f, K, nw).total();
  return p;
}

// A tile's stream bytes [pb, pe) of concat(hist, x) for its `samples`
// samples from output m0 - 1 on, and where they sit in its slot: byte p
// at slot byte p - base, base = pb - off, with off putting the chunks that
// come from x on 16-byte device addresses.  The slot's 16-byte chunks
// [c0, c1) lie wholly in the row's block and inside the tensor x (one
// bulk copy); the others, of the `chunks`, hold history bytes or cross
// the tensor's ends.
struct Span {
  long long pb, pe, base;
  int off, chunks, c0, c1;
};

__device__ __forceinline__ Span span(long long row, long long m0,
                                     long long samples, long long xa,
                                     long long xe, long long n, int H,
                                     int f, int K) {
  Span s;
  s.pb = 2 * (m0 - 1) * f;
  s.pe = s.pb + 2 * u8w::plane_len(samples, f, K);
  const long long xr = xa + row * n;        // the row's block
  s.off = static_cast<int>((xr - H + s.pb) & 15);
  s.base = s.pb - s.off;
  s.chunks = static_cast<int>((s.off + s.pe - s.pb + 15) / 16);
  const long long a = xr - H + s.base;      // chunk c at a + 16 c
  s.c0 = xr <= a ? 0 : static_cast<int>(min((xr - a + 15) / 16,
                                            static_cast<long long>(s.chunks)));
  s.c1 = xe <= a ? 0 : static_cast<int>(min((xe - a) / 16,
                                            static_cast<long long>(s.chunks)));
  if (s.c1 < s.c0) s.c1 = s.c0;
  return s;
}

// u8w::deinterleave by one warp: the staged bytes from raw[off] on ->
// its planes pI, pQ of `len` samples, 16 bytes a lane at a time.  A lane
// reads the 16-byte word its bytes start in and the next (conflict-free
// 16-byte loads), takes the five 4-byte words from the one that holds
// its first byte, funnel-shifts them to the bytes' offset, and writes 8
// samples of each plane (u8w::deinterleave splits 8 bytes a thread).
__device__ __forceinline__ void deinterleave(const unsigned char* raw,
                                             int off, long long len,
                                             unsigned* pI, unsigned* pQ,
                                             int lane) {
  const uint4* v = reinterpret_cast<const uint4*>(raw) + (off >> 4);
  const unsigned sh = 8u * (off & 3);
  const int o = (off >> 2) & 3;         // the first byte's word
  const int spans = static_cast<int>((len + 7) / 8);
  for (int h = lane; h < spans; h += 32) {
    const uint4 a = v[h], b = v[h + 1];
    unsigned w[5];
    switch (o) {
      case 0: w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w; w[4] = b.x;
        break;
      case 1: w[0] = a.y; w[1] = a.z; w[2] = a.w; w[3] = b.x; w[4] = b.y;
        break;
      case 2: w[0] = a.z; w[1] = a.w; w[2] = b.x; w[3] = b.y; w[4] = b.z;
        break;
      default: w[0] = a.w; w[1] = b.x; w[2] = b.y; w[3] = b.z; w[4] = b.w;
    }
    unsigned c[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) c[k] = __funnelshift_r(w[k], w[k + 1], sh);
    reinterpret_cast<uint2*>(pI)[h] =
        make_uint2(__byte_perm(c[0], c[1], 0x6420) ^ 0x80808080u,
                   __byte_perm(c[2], c[3], 0x6420) ^ 0x80808080u);
    reinterpret_cast<uint2*>(pQ)[h] =
        make_uint2(__byte_perm(c[0], c[1], 0x7531) ^ 0x80808080u,
                   __byte_perm(c[2], c[3], 0x7531) ^ 0x80808080u);
  }
}

template <int NW, bool S16>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
u8_front_demod_kernel(const uint8_t* __restrict__ x,
                      const uint8_t* __restrict__ hist,
                      const float* __restrict__ last_iq,
                      const int32_t* __restrict__ tw,
                      float* __restrict__ y, float* __restrict__ iq_out,
                      long long rows, long long n, int H, int K, int f,
                      int nw, long long num, long long W, int stages,
                      float scale) {
  DYNAMIC_SMEM(smem_f);
  unsigned char* const smem = reinterpret_cast<unsigned char*>(smem_f);
  const Layout lay(W, stages, f, K, nw);
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* const empty = full + kMaxStages;
  Head* const heads = reinterpret_cast<Head*>(empty + kMaxStages);
  const long long T = tile_outputs(W);
  const long long per_row = tiles_per_row(num, W);
  const long long tiles = rows * per_row;
  const long long xa = static_cast<long long>(reinterpret_cast<uintptr_t>(x));
  const long long xe = xa + rows * n;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      ring::init(full + s, 32);       // every producer lane
      ring::init(empty + s, kWarps);  // each consumer warp, once
    }
    ring::fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= NT) {
    // the producer warp: tile k of the block into slot k % S, once the
    // consumers have released the tile k - S it held
    const int lane = threadIdx.x - NT;
    int s = 0;
    unsigned phase = 0;
    for (long long i = blockIdx.x, k = 0; i < tiles; i += gridDim.x, ++k) {
      if (k >= stages) ring::wait(empty + s, phase ^ 1);
      long long row, m0;
      persistent::tile_origin(i, per_row, static_cast<int>(T), &row, &m0);
      const long long nt = min(T, num - m0);
      const Span sp = span(row, m0, nt + 1, xa, xe, n, H, f, K);
      unsigned char* const raw = smem + lay.slot_at(s);
      if (lane == 0) {
        heads[s] = Head{row, m0, sp.off, static_cast<int>(nt)};
        const unsigned bytes = 16u * (sp.c1 - sp.c0);
        ring::arrive_tx(full + s, bytes);
        if (bytes) {
          ring::fence_async();
          ring::bulk_load(raw + 16 * sp.c0,
                          x + (row * n + sp.base + 16LL * sp.c0 - H), bytes,
                          full + s);
        }
      } else {
        // the chunks outside [c0, c1), byte by byte
        const uint8_t* hr = hist + row * H;
        const uint8_t* xr = x + row * n;
        const int edge = sp.c0 + (sp.chunks - sp.c1);
        for (int e = lane - 1; e < edge; e += 31) {
          const int c = e < sp.c0 ? e : sp.c1 + (e - sp.c0);
          for (int j = 0; j < 16; ++j) {
            const long long p = sp.base + 16LL * c + j;
            if (p >= sp.pb && p >= 0 && p < sp.pe)
              raw[16 * c + j] = p < H ? hr[p] : xr[p - H];
          }
        }
        ring::arrive(full + s);
      }
      if (++s == stages) {
        s = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // the consumer warps, each on its own W samples of every tile
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const u8w::Planes win{
      reinterpret_cast<unsigned*>(smem + lay.planes_at(w)),
      reinterpret_cast<unsigned*>(smem + lay.planes_at(w) + lay.plane)};
  const u8w::Taps<NW, S16> tp(tw, nw);
  const bool f8 = (f & 7) == 0;
  const long long q0 = (W - 1) * w;     // the warp's first tile sample
  int s = 0;
  unsigned phase = 0;
  // tile i: outputs m0 .. m0 + nt - 1 of row i / per_row, from samples
  // m0 - 1 .. m0 + nt - 1; the warp's samples q0 .. q0 + ws - 1 of them
  for (long long i = blockIdx.x; i < tiles; i += gridDim.x) {
    ring::wait(full + s, phase);
    const Head hd = heads[s];
    const long long row = hd.row, m0 = hd.m0;
    const int ws = static_cast<int>(min(W, hd.nt + 1 - q0));
    if (ws > 1)
      deinterleave(smem + lay.slot_at(s),
                   hd.off + static_cast<int>(2 * q0 * f),
                   u8w::plane_len(ws, f, K), win.pI, win.pQ, lane);
    ring::warp_sync();                  // the warp's planes are whole
    if (lane == 0) ring::arrive(empty + s);
    if (ws > 1) {
      // sample q = lane + 32 j of the warp (the row's first from the
      // carry), then each output's predecessor from the lane before (lane
      // 31 of the step before)
      const bool first = m0 == 0 && w == 0;
      float2 v[kPer];
      auto sums = [&](auto f8c) {   // f8 a constant: one branch a tile
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int q = lane + 32 * j;
          v[j] = make_float2(0.f, 0.f);
          if (32 * j < ws && q < ws)
            v[j] = first && q == 0
                ? make_float2(last_iq[2 * row], last_iq[2 * row + 1])
                : u8w::scaled(u8w::window_sums(win, q * f,
                                               decltype(f8c)::value, tp),
                              scale);
        }
      };
      if (f8)
        sums(std::true_type());
      else
        sums(std::false_type());
      float r[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        if (32 * j >= ws) break;          // the warp's last step
        const float2 up = ring::lane_before(v[j]);
        const float2 wrap = ring::lane_31(v[j > 0 ? j - 1 : 0]);
        const float2 c = v[j], p = lane ? up : wrap;
        const float bq = __fsub_rn(__fmul_rn(c.y, p.x), __fmul_rn(c.x, p.y));
        const float a = __fadd_rn(__fmul_rn(c.x, p.x), __fmul_rn(c.y, p.y));
        r[j] = poly_atan2(bq, a);
      }
      // output q - 1 of the warp at yt[q]; the row's last at q == qe
      float* const yt = y + row * num + m0 + q0 - 1;
      const long long qe = num - m0 - q0;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int q = lane + 32 * j;
        if (q >= 1 && q < ws) {
          yt[q] = r[j];
          if (q == qe) {
            iq_out[2 * row] = v[j].x;
            iq_out[2 * row + 1] = v[j].y;
          }
        }
      }
    }
    if (++s == stages) {
      s = 0;
      phase ^= 1;
    }
  }
}

template <int NW, bool S16>
struct Launch {
  int operator()(const void* x, const void* hist, const void* last_iq,
                 const void* tw, void* y, void* iq_out, long long rows,
                 long long n, int H, int K, int f, int nw, long long num,
                 float scale, cudaStream_t stream) const {
    auto kernel = u8_front_demod_kernel<NW, S16>;
    const Plan p = plan(f, K, nw);
    if (p.W == 0) return static_cast<int>(cudaErrorInvalidValue);
    // blocks that fit at once, asked at kBlockBytes (every plan of three
    // blocks an SM fits it) so that launches of other sizes reuse the query
    int blocks = 0;
    const int e = persistent::resident_blocks(
        kernel, kThreads, p.pair ? kBlockBytes : p.smem, &blocks);
    if (e != 0) return e;
    const long long tiles = rows * tiles_per_row(num, p.W);
    KERNEL_LAUNCH_SMEM(
        kernel,
        static_cast<unsigned>(std::min(tiles, static_cast<long long>(blocks))),
        kThreads, p.smem, stream, static_cast<const uint8_t*>(x),
        static_cast<const uint8_t*>(hist), static_cast<const float*>(last_iq),
        static_cast<const int32_t*>(tw), static_cast<float*>(y),
        static_cast<float*>(iq_out), rows, n, H, K, f, nw, num, p.W,
        p.stages, scale);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

// x [rows, n] u8, hist [rows, H] u8, last_iq [rows, 2] f32, tw the packed
// tap words ([nw] s8, [2, nw] for 16-bit taps: kernels/u8_front.py:
// pack_taps) -> y [rows, num] f32, iq_out [rows, 2] f32.  The caller
// checks that every window lies inside concat(hist, x).
extern "C" int launch_u8_front_demod(const void* x, const void* hist,
                                     const void* last_iq, const void* tw,
                                     void* y, void* iq_out, long long rows,
                                     long long n, int H, int K, int f,
                                     int nw, int s16, long long num,
                                     float scale, void* stream) {
  return u8w::dispatch<Launch>(nw, s16 != 0, x, hist, last_iq, tw, y,
                               iq_out, rows, n, H, K, f, nw, num, scale,
                               static_cast<cudaStream_t>(stream));
}

// The plan launch_u8_front_demod makes: samples a consumer warp takes of
// a tile (0: none fits), slots, three blocks an SM or one, shared-memory
// bytes a block.
extern "C" int u8_front_demod_plan(int f, int K, int nw, long long* W,
                                   int* stages, int* pair,
                                   long long* smem) {
  const Plan p = plan(f, K, nw);
  *W = p.W;
  *stages = p.stages;
  *pair = p.pair ? 1 : 0;
  *smem = p.smem;
  return 0;
}

extern "C" const char* kernel_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// This library links its own CUDA runtime, whose current device is not
// PyTorch's: the wrapper selects the tensors' device before each launch.
extern "C" int kernel_set_device(int device) {
  return static_cast<int>(cudaSetDevice(device));
}
