// One-launch two-pass scans over rows: tickets in waves of rows.
//
// K12's and K13's scans take two passes over each row.  The first reads a
// tile and leaves its summary (a tile's end state, its chunk maps); the
// last first-pass block of a row, found by the row's completion counter,
// turns the row's summaries into the state entering each tile, in an
// order fixed by the geometry, and publishes a ready flag; the output
// pass reads the tile again and runs it from its entering state.  One
// launch holds both passes:
//
//   * every block first takes a ticket from a counter (atomicAdd), and
//     decode() maps tickets to work in a fixed order, so a block only
//     ever waits on work whose ticket is lower: that block is resident
//     and waits on nothing itself, so the launch cannot deadlock;
//   * rows run in waves of `wave` rows, and the tickets go: the first
//     pass of wave 0, then for k = 1, 2, ... the first pass of wave k and
//     the output pass of wave k-1, then the output pass of the last wave.
//     A wave's input is read again a wave later, while it is still in
//     the L2 cache, and its rows' summaries are ready long before their
//     output tickets come up;
//   * a wait spins on the ready flag a bounded number of times and then
//     traps, so that a fault becomes a launch error and not a hang;
//   * the counters live in the launch's scratch and are zeroed on the
//     stream (cudaMemsetAsync) before the kernel, so stream capture can
//     hold both.
//
// Every order of composition is the geometry's: which block happens to be
// a row's last changes nothing in what it computes.  Both passes stage
// their tile with copy4 (cp.async: no register holds the data).

#pragma once

namespace tickets {

struct Waves {
  long long rows;       // rows of the launch
  long long wave;       // rows a wave
  long long first;      // first-pass tickets a row (may be 0)
  long long out;        // output-pass tickets a row (at least 1)
};

struct Work {
  int pass;             // 0: first pass, 1: output pass
  long long row, tile;  // tile: the row's ticket of that pass
};

// Rows a wave: as many whole rows as fit `bytes` of input, at least one.
inline long long wave_rows(long long row_bytes, long long bytes,
                           long long rows) {
  long long w = row_bytes > 0 ? bytes / row_bytes : rows;
  if (w < 1) w = 1;
  return w < rows ? w : rows;
}

// Counter words a launch needs: the ticket, then each row's completion
// count and ready flag (an even count, so what follows stays 8-byte
// aligned).
inline long long counter_words(long long rows) { return 2 * rows + 2; }

__host__ __device__ inline long long total(const Waves& w) {
  return w.rows * (w.first + w.out);
}

__device__ inline Work first_of(const Waves& w, long long k, long long u) {
  return Work{0, k * w.wave + u / w.first, u % w.first};
}

__device__ inline Work out_of(const Waves& w, long long k, long long u) {
  return Work{1, k * w.wave + u / w.out, u % w.out};
}

// Ticket t's work (0 <= t < total(w)).
__device__ inline Work decode(const Waves& w, long long t) {
  const long long waves = (w.rows + w.wave - 1) / w.wave;
  const long long last_rows = w.rows - (waves - 1) * w.wave;
  const long long A = w.wave * w.first, B = w.wave * w.out;
  const long long f0 = (waves == 1 ? last_rows : w.wave) * w.first;
  if (t < f0) return first_of(w, 0, t);
  t -= f0;
  if (waves >= 2) {
    // groups k = 1 .. waves - 2: the first pass of wave k (A tickets),
    // then the output pass of wave k - 1 (B)
    const long long full = (waves - 2) * (A + B);
    if (t < full) {
      const long long k = 1 + t / (A + B), u = t % (A + B);
      return u < A ? first_of(w, k, u) : out_of(w, k - 1, u - A);
    }
    t -= full;
    // the last wave's first pass, then the output pass of the one before
    const long long fl = last_rows * w.first;
    if (t < fl) return first_of(w, waves - 1, t);
    t -= fl;
    if (t < B) return out_of(w, waves - 2, t);
    t -= B;
  }
  return out_of(w, waves - 1, t);
}

// The block's ticket: thread 0 takes it, every thread gets it.
__device__ inline long long take(unsigned* counter) {
  __shared__ unsigned ticket;
  if (threadIdx.x == 0) ticket = atomicAdd(counter, 1u);
  __syncthreads();
  return ticket;
}

// After a first-pass block has written its summary (each thread that
// wrote a part of it fenced after its writes): counts it for row r (of
// `first` blocks) and returns, to every thread, whether it was the row's
// last.  The last one may then read every summary of the row.
__device__ inline bool finish(unsigned* done, long long r, long long first) {
  __shared__ int last;
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(done + r, 1u) == static_cast<unsigned>(first - 1);
  __syncthreads();
  const bool is_last = last != 0;
  if (is_last) __threadfence();
  return is_last;
}

// Publish row r's entering states, written by this block.
__device__ inline void publish(unsigned* ready, long long r) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *reinterpret_cast<volatile unsigned*>(ready + r) = 1u;
}

// 4 bytes from device memory at g to shared memory at d without a round
// trip through registers (cp.async, waited for by copy_wait; a plain copy
// where the source is built for the host)
__device__ __forceinline__ void copy4(float* d, const float* g) {
#ifdef __CUDA_ARCH__
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(d));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(g));
#else
  *d = *g;
#endif
}

__device__ __forceinline__ void copy_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::);
#endif
}

constexpr long long kMaxSpins = 1LL << 24;   // about 2 s: then a trap

// The flag at p, loaded with acquire semantics: what its publisher wrote
// before it is then visible.
__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
#ifdef __CUDA_ARCH__
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
#else
  return __atomic_load_n(p, __ATOMIC_ACQUIRE);
#endif
}

// Wait until row r's entering states are published (bounded).  Thread 0
// waits; the caller's next __syncthreads holds the block.
__device__ inline void wait(const unsigned* ready, long long r) {
  if (threadIdx.x == 0) {
    long long spins = 0;
    while (load_acquire(ready + r) == 0u) {
      if (++spins > kMaxSpins) __trap();
      __nanosleep(100);
    }
  }
}

}  // namespace tickets
