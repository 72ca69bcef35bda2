"""K1's ring (csrc/u8_front_demod.cu) on the CPU: its tile and ring plan,
each tile's copies and the ring's barriers as numpy models, and the CUDA
source itself compiled for the host with ``g++`` under
tests/torch_host_shim.py and run block by block, its threads as
std::threads.

* ``ring_plan`` (kernels/u8_front_demod.py) equals the source's exported
  plan (the largest tile whose ring fits three blocks an SM), and at the
  port's geometries (mono's [32, 10,485,760], the
  streamed [1, 1,310,720], ``shard_carry``'s one output a row over
  ``H + 2f`` bytes, an odd history, a block not a multiple of 16 bytes,
  f in {4, 8, 16} x K in {31, 51, 64}) every output falls in exactly one
  warp's stretch of one tile, and a slot holds the tile's copies and each
  warp's deinterleave's read.
* Each tile's copies, as the producer warp computes them: the bulk copy's
  device address and byte count are 16-byte multiples inside ``x`` and
  inside the row's block; every byte of the history, and every chunk that
  crosses the tensor's ends, takes the per-byte path, and no other chunk
  does; the two paths cover the tile's bytes once.
* The ring's full and empty barriers, modelled as mbarriers (arrival
  count, transaction bytes, phase parity) under random interleavings of
  the producer, the eight consumer warps and the copies' completions: no
  slot is refilled before every warp releases it, a warp reads a slot
  only once its tile has landed, and every schedule ends.
* The host build, bitwise ``u8_front_demod_reference`` at s8 (tap words
  in registers) and s16 taps, f in {1, 4, 8, 16}, K in {16, 31, 51, 64},
  histories 86, 87 and 2 bytes, row bases off 16-byte alignment, one
  output a row, one tile, tiles of 32, 64 and 128 samples a warp, the
  one-block-an-SM fallback, and a ring of one slot (every tile waits for
  its slot's release); its plan equals ``ring_plan``.
"""

import ctypes
import re

import numpy as np
import pytest
import torch

import torch_host_shim as host_shim

from sdr_tpu_torch.kernels import _build, u8_front_demod as k1
from sdr_tpu_torch.kernels.u8_front import pack_taps
from sdr_tpu_torch.ops.quantized import u8_front_plan

XA = 0x7F00_0000_0000        # a device address of x, 16-byte aligned


def nw_of(K):
    return pack_taps(np.ones(K, np.int32)).shape[-1]


# rows, n, H, K, f, num (None: the most the stream holds), x's base offset
GEOMETRIES = {
    "mono": (32, 10_485_760, 86, 51, 8, None, 0),
    "streamed": (1, 1_310_720, 86, 51, 8, None, 0),
    "shard_carry": (32, 16, 86, 51, 8, 1, 0),
    "odd_history": (3, 200_000, 87, 51, 8, None, 0),
    "n_not_16": (3, 200_006, 86, 51, 8, None, 6),
    **{f"f{f}_K{K}": (4, 300_002, 2 * max(K - f, 0), K, f, None, 1)
       for f in (4, 8, 16) for K in (31, 51, 64)},
}


def most(n, H, K, f):
    return (H + n - 2 * K) // (2 * f) + 1


def tiles(rows, n, H, K, f, num, plan):
    """Every tile of the launch: row, first output m0, outputs nt."""
    T = k1.tile_outputs(plan["W"])
    per_row = k1.tiles_per_row(num, plan["W"])
    i = np.arange(rows * per_row, dtype=np.int64)
    row, m0 = i // per_row, (i % per_row) * T
    return row, m0, np.minimum(T, num - m0)


def spans(rows, n, H, K, f, m0, nt, row, xa):
    """The kernel's `span` for each tile (numpy int64): its nt + 1
    samples' stream bytes."""
    pb = 2 * (m0 - 1) * f
    pe = pb + 2 * (nt * f + K)
    xr = xa + row * n
    off = (xr - H + pb) & 15
    base = pb - off
    chunks = (off + pe - pb + 15) // 16
    a = xr - H + base
    xe = xa + rows * n
    c0 = np.where(xr <= a, 0, np.minimum((xr - a + 15) // 16, chunks))
    c1 = np.where(xe <= a, 0, np.minimum((xe - a) // 16, chunks))
    c1 = np.maximum(c1, c0)
    return dict(pb=pb, pe=pe, off=off, base=base, chunks=chunks, a=a,
                c0=c0, c1=c1, xr=xr, xe=xe)


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_tiles_cover_every_output_once(name):
    rows, n, H, K, f, num, _ = GEOMETRIES[name]
    num = num or most(n, H, K, f)
    plan = k1.ring_plan(f, K, nw_of(K))
    W = plan["W"]
    assert W in (32, 64, 128) and plan["pair"]
    assert k1.MIN_STAGES <= plan["stages"] <= k1.MAX_STAGES
    assert plan["smem"] <= k1.BLOCK_BYTES
    row, m0, nt = tiles(rows, n, H, K, f, num, plan)
    assert (nt >= 1).all()
    # each warp's outputs: its samples q = 1 .. ws - 1
    hits = np.zeros((rows, num), np.int32)
    sp = spans(rows, n, H, K, f, m0, nt, row, XA)
    slot = k1.slot_bytes(W, f, K)
    assert (16 * sp["chunks"] <= slot).all()
    for w in range(k1.WARPS):
        q0 = (W - 1) * w
        ws = np.minimum(W, nt + 1 - q0)
        busy = ws > 1
        for r, lo, cnt in zip(row[busy], (m0 + q0)[busy], ws[busy] - 1):
            hits[r, lo: lo + cnt] += 1
        # the warp's deinterleave reads 16-byte words inside the slot:
        # two from the one that holds each lane's first byte
        reads = (k1.plane_len(ws, f, K) + 7) // 8
        off_w = sp["off"] + 2 * q0 * f
        assert ((off_w & ~15) + 16 * reads + 16 <= slot)[busy].all()
    assert (hits == 1).all()


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_bulk_copies_are_aligned_inside_x_and_edges_go_byte_by_byte(name):
    rows, n, H, K, f, num, shift = GEOMETRIES[name]
    num = num or most(n, H, K, f)
    plan = k1.ring_plan(f, K, nw_of(K))
    row, m0, nt = tiles(rows, n, H, K, f, num, plan)
    xa = XA + shift
    sp = spans(rows, n, H, K, f, m0, nt, row, xa)
    a, c0, c1, chunks = sp["a"], sp["c0"], sp["c1"], sp["chunks"]
    assert (a % 16 == 0).all()
    bulk = c1 > c0
    lo, hi = a + 16 * c0, a + 16 * c1
    # 16-byte device addresses and counts, inside x and the row's block
    assert (lo[bulk] % 16 == 0).all() and ((hi - lo) % 16 == 0).all()
    assert (lo[bulk] >= sp["xr"][bulk]).all()
    assert (hi[bulk] <= sp["xe"]).all() and (lo[bulk] >= xa).all()
    # no chunk left to the per-byte path lies wholly in the block and x
    first_out = (c0 == 0) | (a + 16 * (c0 - 1) < sp["xr"])
    last_out = (c1 == chunks) | (a + 16 * (c1 + 1) > sp["xe"])
    assert (first_out & last_out).all()
    # the history bytes a tile reads take the per-byte path
    need_lo = np.maximum(sp["pb"], 0)
    reads_hist = need_lo < H
    assert (sp["base"] + 16 * c0 >= np.minimum(sp["pe"], H))[
        reads_hist].all()
    # the two paths cover [max(pb, 0), pe) once: the chunks do
    assert (sp["base"] <= need_lo).all()
    assert (sp["base"] + 16 * chunks >= sp["pe"]).all()
    # per-byte chunks only where a tile reads history or nears x's end
    edge = (c0 > 0) | (c1 < chunks)
    assert (reads_hist | (a + 16 * chunks > sp["xe"]) | (
        sp["a"] < sp["xr"]))[edge].all()
    if name == "mono":
        # only a row's first tile and the tensor's last take edge bytes
        assert edge.sum() == rows + 1 or edge.sum() == rows


def test_plan_at_the_paths():
    """The paths' plans: the FM front's tiles of 1,016 outputs (128
    samples a warp) in 3 slots, three blocks an SM, whatever the launch's
    length; f = 16 at 64 taps 64 samples a warp; a window too wide for
    three blocks an SM takes one, and one too wide for a block none."""
    p = k1.ring_plan(8, 51, 14)
    assert (p["W"], p["stages"], p["pair"]) == (128, 3, True)
    assert k1.tile_outputs(128) == 1016
    assert 3 * (p["smem"] + 1024) <= 233_472
    assert k1.ring_plan(16, 64, 16)["W"] == 64
    wide = k1.ring_plan(64, 255, 64)
    assert (wide["W"], wide["pair"]) == (32, False)
    assert wide["smem"] <= k1.MAX_SMEM
    assert k1.ring_plan(400, 2_000, 500)["W"] == 0


# -- the ring's barriers ---------------------------------------------------

class MBarrier:
    """An mbarrier: pending arrivals and transaction bytes; the phase
    completes when both reach 0, and a wait on parity p passes once the
    phase's parity differs from p."""

    def __init__(self, count):
        self.count, self.pending, self.tx, self.phase = count, count, 0, 0

    def arrive(self, tx=0):
        self.tx += tx
        self.pending -= 1
        self._complete()

    def complete_tx(self, nbytes):
        self.tx -= nbytes
        self._complete()

    def _complete(self):
        assert self.pending >= 0
        if self.pending == 0 and self.tx == 0:
            self.phase ^= 1
            self.pending = self.count

    def passed(self, parity):
        return (self.phase & 1) != parity


def run_ring(stages, ntiles, seed, warps=8):
    """The kernel's producer loop and each consumer warp's loop as
    generators, one step of one of them at a time in a random order, with
    each bulk copy landing at a random later step."""
    rng = np.random.default_rng(seed)
    full = [MBarrier(32) for _ in range(stages)]
    empty = [MBarrier(warps) for _ in range(stages)]
    slot = [None] * stages          # (tile, bytes landed)
    released = [0] * ntiles         # warps that released each tile
    inflight, log = [], [[] for _ in range(warps)]

    def producer():
        s, phase = 0, 0
        for k in range(ntiles):
            if k >= stages:
                while not empty[s].passed(phase ^ 1):
                    yield
            assert k < stages or released[k - stages] == warps, (k, s)
            slot[s] = (k, False)
            full[s].arrive(tx=16)           # lane 0: arrive_tx, then copy
            inflight.append(s)
            yield
            for _ in range(31):             # the other lanes' bytes
                full[s].arrive()
            yield
            s, phase = (0, phase ^ 1) if s + 1 == stages else (s + 1, phase)

    def consumer(w):
        s, phase = 0, 0
        for k in range(ntiles):
            while not full[s].passed(phase):
                yield
            assert slot[s] == (k, True), (w, k, slot[s])
            log[w].append(k)
            yield                           # the warp's deinterleave
            released[k] += 1
            empty[s].arrive()
            yield                           # sums, demod, stores
            s, phase = (0, phase ^ 1) if s + 1 == stages else (s + 1, phase)

    actors = [producer()] + [consumer(w) for w in range(warps)]
    done = [False] * len(actors)
    for _ in range(400 * (ntiles + stages) * warps + 1000):
        if all(done) and not inflight:
            break
        pick = rng.integers(len(actors) + 1)
        if pick == len(actors):
            if inflight:
                s = inflight.pop(rng.integers(len(inflight)))
                slot[s] = (slot[s][0], True)
                full[s].complete_tx(16)
            continue
        if not done[pick]:
            try:
                next(actors[pick])
            except StopIteration:
                done[pick] = True
    assert all(done) and not inflight, "the ring did not finish"
    assert log == [list(range(ntiles))] * warps


@pytest.mark.parametrize("stages", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("ntiles", [1, 2, 7, 40])
def test_no_slot_is_refilled_before_its_release(stages, ntiles):
    for seed in range(20):
        run_ring(stages, ntiles, seed)


def test_the_models_parities_are_the_kernels():
    """The model's waits are the source's: the producer waits on the
    empty barrier at its phase ^ 1 from its S-th tile on, the consumers on
    the full barrier at theirs, and both flip the phase as the slot
    wraps."""
    src = (_build.CSRC / "u8_front_demod.cu").read_text()
    assert "if (k >= stages) ring::wait(empty + s, phase ^ 1);" in src
    assert "ring::wait(full + s, phase);" in src
    assert len(re.findall(r"if \(\+\+s == stages\) \{\s*s = 0;\s*"
                          r"phase \^= 1;", src)) == 2
    assert "ring::init(full + s, 32);" in src
    assert "ring::init(empty + s, kWarps);" in src
    assert "if (lane == 0) ring::arrive(empty + s);" in src
    assert src.count("ring::arrive(empty + s);") == 1
    assert src.count("ring::arrive(full + s);") == 1
    assert src.count("ring::arrive_tx(full + s, bytes);") == 1


# -- the source on the host -------------------------------------------------

HOST_INTRINSICS = r"""
struct int2 { int x, y; };
inline int2 make_int2(int a, int b) { return {a, b}; }
struct alignas(16) uint4 { unsigned x, y, z, w; };
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
inline unsigned __funnelshift_r(unsigned lo, unsigned hi, unsigned sh) {
  return static_cast<unsigned>(
      ((static_cast<uint64_t>(hi) << 32) | lo) >> (sh & 31));
}
inline unsigned __byte_perm(unsigned a, unsigned b, unsigned s) {
  const uint64_t v = (static_cast<uint64_t>(b) << 32) | a;
  unsigned r = 0;
  for (int i = 0; i < 4; ++i)
    r |= static_cast<unsigned>((v >> (8 * ((s >> (4 * i)) & 7))) & 0xFF)
         << (8 * i);
  return r;
}
inline int __dp4a(int a, int b, int c) {
  for (int i = 0; i < 4; ++i)
    c += static_cast<int8_t>(a >> (8 * i)) * static_cast<int8_t>(b >> (8 * i));
  return c;
}
inline float __int2float_rn(int v) { return static_cast<float>(v); }
"""

# mbarriers keyed by address (a launch's blocks run in turn, each
# initialising its own), the bulk copy a memcpy that completes its bytes,
# the consumers' named barrier a std::barrier of NT
HOST_RING = r"""
#include <condition_variable>
#include <map>
#include <memory>
#include <mutex>
namespace ring {
struct Bar { int count, pending; long long tx; unsigned phase; };
inline std::mutex mu;
inline std::condition_variable cv;
inline std::map<const void*, Bar> bars;
inline void complete(Bar& b) {
  if (b.pending == 0 && b.tx == 0) {
    b.phase ^= 1;
    b.pending = b.count;
    cv.notify_all();
  }
}
inline void init(uint64_t* bar, unsigned count) {
  std::lock_guard<std::mutex> l(mu);
  bars[bar] = Bar{static_cast<int>(count), static_cast<int>(count), 0, 0};
}
inline void fence_init() {}
inline void arrive(uint64_t* bar) {
  std::lock_guard<std::mutex> l(mu);
  Bar& b = bars.at(bar);
  if (--b.pending < 0) std::abort();
  complete(b);
}
inline void arrive_tx(uint64_t* bar, unsigned bytes) {
  std::lock_guard<std::mutex> l(mu);
  Bar& b = bars.at(bar);
  b.tx += bytes;
  if (--b.pending < 0) std::abort();
  complete(b);
}
inline void wait(uint64_t* bar, unsigned parity) {
  std::unique_lock<std::mutex> l(mu);
  cv.wait(l, [&] { return (bars.at(bar).phase & 1) != parity; });
}
inline void bulk_load(void* dst, const void* src, unsigned bytes,
                      uint64_t* bar) {
  if (reinterpret_cast<uintptr_t>(dst) % 16 ||
      reinterpret_cast<uintptr_t>(src) % 16 || bytes % 16)
    std::abort();
  std::memcpy(dst, src, bytes);
  std::lock_guard<std::mutex> l(mu);
  Bar& b = bars.at(bar);
  b.tx -= bytes;
  complete(b);
}
inline void fence_async() {}
// a consumer warp's 32 threads: a barrier and an exchange buffer a warp
inline std::barrier<>& warp_barrier() {
  static std::barrier<>* const b = [] {
    auto* p = std::allocator<std::barrier<>>().allocate(u8w::NT / 32);
    for (int w = 0; w < u8w::NT / 32; ++w) new (p + w) std::barrier<>(32);
    return p;
  }();
  return b[threadIdx.x / 32];
}
inline void warp_sync() { warp_barrier().arrive_and_wait(); }
alignas(16) inline float2 lanes[u8w::NT];
inline float2 lane_from(float2 v, int src) {
  lanes[threadIdx.x] = v;
  warp_sync();
  const float2 out = lanes[threadIdx.x / 32 * 32 + src];
  warp_sync();
  return out;
}
inline float2 lane_before(float2 v) {
  const int l = threadIdx.x % 32;
  return lane_from(v, l ? l - 1 : 0);
}
inline float2 lane_31(float2 v) { return lane_from(v, 31); }
}  // namespace ring
"""

DP4A_US = ('asm("dp4a.u32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), '
           '"r"(c));')
DP4A_US_HOST = ("d = c;\n  for (int i = 0; i < 4; ++i)\n"
                "    d += static_cast<int>((static_cast<unsigned>(a) >> "
                "(8 * i)) & 0xFF) * static_cast<int8_t>(b >> (8 * i));")
BLOCKS = 2                   # resident blocks: each walks several tiles


def host_patches():
    """The whole source on the host: u8_window.cuh inlined over the
    shim's persistent.cuh (two resident blocks, synchronous copies) with
    its one inline PTX line in C++, the ring's primitives as above."""
    window = (_build.CSRC / "u8_window.cuh").read_text()
    window = window.replace("#pragma once\n", "").replace(
        "#include <cuda_runtime.h>\n", "")
    assert window.count('#include "persistent.cuh"') == 1
    assert window.count(DP4A_US) == 1
    window = window.replace('#include "persistent.cuh"',
                            host_shim.persistent(BLOCKS)).replace(
        DP4A_US, DP4A_US_HOST)
    src = (_build.CSRC / "u8_front_demod.cu").read_text()
    ring = re.search(r"namespace ring \{.*?\}  // namespace ring\n", src,
                     re.S).group(0)
    return [('#include "u8_window.cuh"', HOST_INTRINSICS + window),
            (ring, ""),
            ("namespace {\n\nusing u8w::NT;",
             HOST_RING + "\nnamespace {\n\nusing u8w::NT;")]


ONE_SLOT = [("constexpr int kMinStages = 3, kMaxStages = 8;",
             "constexpr int kMinStages = 1, kMaxStages = 1;")]


def _bind(lib):
    lib.launch_u8_front_demod.argtypes = [
        *k1.KERNEL.functions["launch_u8_front_demod"], ctypes.c_void_p]
    lib.u8_front_demod_plan.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_longlong)]
    return lib


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    d = tmp_path_factory.mktemp("host_k1")
    return {"ring": _bind(host_shim.build_source(d, "u8_front_demod",
                                                 host_patches())),
            "one_slot": _bind(host_shim.build_source(
                d, "u8_front_demod", host_patches() + ONE_SLOT,
                tag="_one_slot"))}


def host_plan(lib, f, K, nw):
    W, st, pair, smem = (ctypes.c_longlong(), ctypes.c_int(),
                         ctypes.c_int(), ctypes.c_longlong())
    assert lib.u8_front_demod_plan(f, K, nw,
                                   ctypes.byref(W), ctypes.byref(st),
                                   ctypes.byref(pair),
                                   ctypes.byref(smem)) == 0
    return dict(W=W.value, stages=st.value, pair=bool(pair.value),
                smem=smem.value)


def host_run(lib, tq, scale, f, x, hist, last_iq, num):
    words = torch.from_numpy(pack_taps(tq.numpy()))
    rows = x.shape[0]
    y = torch.full((rows, num), float("nan"))
    iq = torch.full((rows, 2), float("nan"))
    rc = lib.launch_u8_front_demod(
        x.data_ptr(), hist.data_ptr(), last_iq.data_ptr(),
        words.data_ptr(), y.data_ptr(), iq.data_ptr(), rows, x.shape[-1],
        hist.shape[-1], tq.numel(), f, words.shape[-1],
        int(words.shape[0] == 2), num, float(scale), None)
    assert rc == 0
    return y, iq


# f, K, precision, rows, n, H, num (None: the most), x's offset
HOST_CASES = {
    "f8_K51_s8": (8, 51, "s8", 2, 2 * 8 * 1023 * 7 + 600, 86, None, 0),
    "f8_K51_s16": (8, 51, "s16", 2, 2 * 8 * 1023 * 3 + 34, 86, None, 5),
    "odd_history": (8, 51, "s8", 3, 2 * 8 * 1023 * 2 + 4, 87, None, 3),
    "short_history": (4, 16, "s8", 2, 40_006, 2, None, 15),
    "one_output_a_row": (8, 51, "s8", 4, 16, 86, 1, 1),
    "one_tile": (8, 51, "s8", 1, 2 * 8 * 200 + 6, 86, None, 0),
    "f1_K31": (1, 31, "s8", 2, 9_001, 60, None, 7),
    "f4_K64_s16": (4, 64, "s16", 2, 30_010, 120, None, 2),
    "f16_K64_warp64": (16, 64, "s8", 2, 2 * 16 * 511 * 5 + 18, 96, None,
                       9),
    "f16_K31": (16, 31, "s16", 1, 50_000, 30, None, 4),
    "one_block_an_sm": (64, 255, "s8", 1, 2 * 64 * 600, 382, None, 11),
}


@pytest.mark.parametrize("build", ["ring", "one_slot"])
@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_host_build_is_bitwise_the_reference(host_libs, case, build):
    f, K, precision, rows, n, H, num, shift = HOST_CASES[case]
    lib = host_libs[build]
    rng = np.random.default_rng(sum(map(ord, case)))
    tq, scale = u8_front_plan(rng.uniform(-1, 1, K).astype(np.float32),
                              precision)
    tq = torch.from_numpy(tq)
    x = host_shim.offset(torch.from_numpy(
        rng.integers(0, 256, (rows, n)).astype(np.uint8)), shift)
    hist = torch.from_numpy(rng.integers(0, 256, (rows, H)).astype(np.uint8))
    last = torch.from_numpy(rng.normal(size=(rows, 2)).astype(np.float32))
    num = num or most(n, H, K, f)
    plan = host_plan(lib, f, K, nw_of(K))
    if build == "ring":
        assert plan == k1.ring_plan(f, K, nw_of(K))
        if case == "f16_K64_warp64":
            assert plan["W"] == 64
        if case == "one_tile":
            assert k1.tiles_per_row(num, plan["W"]) == 1
        if case == "one_block_an_sm":
            assert not plan["pair"]
    else:
        assert plan["stages"] == 1
    y, iq = host_run(lib, tq, scale, f, x, hist, last, num)
    want_y, want_iq = k1.u8_front_demod_reference(tq, scale, f, x, hist,
                                                  last, num)
    assert torch.equal(y, want_y)
    assert torch.equal(iq, want_iq)


@pytest.mark.parametrize("geometry", [(8, 51), (16, 64), (1, 31), (4, 16),
                                      (64, 255), (400, 2_000)])
def test_ring_plan_mirrors_the_source(host_libs, geometry):
    f, K = geometry
    nw = nw_of(K)
    assert host_plan(host_libs["ring"], f, K, nw) == k1.ring_plan(f, K, nw)
