"""Worker process of tests/test_torch_sharded.py and
tests/test_torch_multihost.py: one rank of a gloo process group on the
CPU, running the port's sharded runners (sdr_tpu_torch.parallel).

    python tests/torch_sharded_worker.py MODE RANK WORLD STORE IN OUT

MODE ``sharded`` (world 4): every scenario of ``SCENARIOS`` on the rank's
span of the inputs in the ``.npz`` IN (time spans of a 4-rank ``"t"``
mesh, channel spans of a ``"c"`` mesh, or both on a 2 x 2 grid), then the
halo helpers on their own, then each scenario of ``COMPILED`` through
the eager runner and the compiled one (``compile_*_sharded``) on two
input contents, a segmented run with carries over two calls, and the
compiled calls' refusals and agreement; it writes the rank's outputs to
the ``.npz`` OUT, and for a chain the runners refuse, the error's text.
MODE ``multihost`` (world 2): each rank reads only its span of the recording
IN through ``host_block_iterator``, runs the mono chain time-sharded, and
rank 0 writes the joined output of each global block.  STORE is the
``file://`` rendezvous of the process group.  Imports torch and the port
only.  Not collected by pytest (no ``test_`` prefix).
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import scipy.signal
import torch

from sdr_tpu_torch.apps import chains
from sdr_tpu_torch.ops import design
from sdr_tpu_torch.ops.channelize import channelizer_taps
from sdr_tpu_torch.parallel import halo
from sdr_tpu_torch.parallel import (channel_time_mesh,
                                    compile_channel_sharded,
                                    compile_grid_sharded,
                                    compile_time_sharded, gather_time_sharded,
                                    global_time_sharded, host_block_iterator,
                                    init_distributed, local_time_span,
                                    make_mesh, run_channel_sharded,
                                    run_grid_sharded, run_time_batched,
                                    run_time_sharded, time_mesh)
from sdr_tpu_torch.stream.pipeline import _unflatten, flatten_carries
from sdr_tpu_torch.stream import (Agc, Channelize, DcBlocker, FftStream, Fir,
                                  FmDemod, Iir, IqConvertU8, Mix, Scale)

CPU = "cpu"
HERE = Path(__file__).resolve().parent
TIMEOUT_S = 600                 # a rank's limit: a hang fails the run
BUTTER4 = scipy.signal.butter(4, 0.2, output="sos").astype(np.float32)
MULTIHOST_ROW = 81_920          # u8 bytes a block-parallel row
MULTIHOST_ROWS = 2              # rows a rank, each global block


def fm_exact_ops():
    """The explicit FM chain of tests/test_parallel.py (its taps)."""
    ws, ham = design.windowed_sinc, design.hamming
    return [IqConvertU8(device=CPU), Fir.decimator(ws(51, 0.1, ham), 8,
                                                   device=CPU),
            FmDemod(device=CPU),
            Fir.resampler(ws(31, 0.25, ham), 3, 10, device=CPU),
            Fir.filter(ws(64, 0.5, ham), device=CPU), Scale(0.2, device=CPU)]


def _fir_taps():
    return np.random.default_rng(1).uniform(-1, 1, 63).astype(np.float32)


# name -> (mode, input key, blocks a rank, ops); mode "time" shards the
# last axis over the "t" mesh of all ranks, "channel" the channel axis
# (-2) over a "c" mesh, "grid" both on the 2 x 2 {"c", "t"} mesh
SCENARIOS = {
    "fir": ("time", "real", 2, lambda: [Fir.filter(_fir_taps(),
                                                   device=CPU)]),
    "fm_exact": ("time", "raw", 2, fm_exact_ops),
    "dc_blocker": ("time", "real_dc", 2, lambda: [DcBlocker(device=CPU)]),
    "mix": ("time", "cplx", 2, lambda: [Mix(0.05, device=CPU)]),
    "mix_planar": ("time", "planar", 2,
                   lambda: [Mix(0.1234567, planar=True, device=CPU)]),
    "fft_stream": ("time", "cplx", 2, lambda: [FftStream(256, 128,
                                                         device=CPU)]),
    "channel": ("channel", "bank", 1, lambda: [
        Fir.decimator(design.windowed_sinc(33, 0.2, design.hamming), 4,
                      device=CPU), FmDemod(device=CPU)]),
    "grid": ("grid", "bank_long", 2, lambda: [
        Fir.decimator(design.windowed_sinc(51, 0.1, design.hamming), 8,
                      device=CPU), FmDemod(device=CPU)]),
    "agc_scan_refused": ("time", "agc", 2, lambda: [
        Agc(0.01, 1.0, method="scan", device=CPU)]),
    "agc_linear": ("time", "agc", 2, lambda: [Agc(0.005, 1.0, device=CPU)]),
    # one block a rank: the sweeps' result depends on the blocks, and the
    # JAX runner runs one a device
    "agc_approx": ("time", "agc", 1, lambda: [
        Agc(0.005, 1.0, method="scan", approx_time_sharding=2,
            device=CPU)]),
    "iir": ("time", "real", 2, lambda: [Iir(BUTTER4, device=CPU)]),
    "am_planar": ("time", "raw", 2, lambda: chains.am_chain(device=CPU)),
    "fm_deemphasis": ("time", "raw", 2, lambda: chains.fm_chain(
        deemphasis=75e-6, deemphasis_mode="iir", device=CPU)),
    # the five scenarios of __graft_entry__.py:dryrun_multichip
    "dry_grid_fm": ("grid", "raw_grid", 1, lambda: chains.fm_chain(
        device=CPU)),
    "dry_wideband": ("time", "wide", 1, lambda: [
        Channelize(channelizer_taps(4, 4), 4, device=CPU),
        FmDemod(device=CPU), DcBlocker(device=CPU)]),
    "dry_quantized": ("time", "raw_q", 1, lambda: chains.fm_chain(
        front="quantized", device=CPU)),
    "dry_fused": ("time", "raw_q", 1, lambda: chains.fm_chain(
        front="fused", front_precision="s8", device=CPU)),
    "dry_stereo": ("time", "raw_s", 1, lambda: chains.fm_chain(
        front="quantized", stereo=True, deemphasis=75e-6, fuse_back=True,
        device=CPU)),
}

# the halo helpers' inputs: rows of one stream, 2 a rank
HALO_ROWS = 2

# name -> (mode, input key, blocks a rank, ops) of the compiled runners,
# each run on the inputs KEY and KEY + "2"; modes as SCENARIOS'
COMPILED = {
    "mono": ("time", "raw", 2, lambda: chains.fm_chain(device=CPU)),
    "am": ("time", "raw", 2, lambda: chains.am_chain(device=CPU)),
    "bank_channel": ("channel", "bank_long", 1,
                     lambda: chains.channelizer_chain(4, device=CPU)),
    "bank_grid": ("grid", "bank_long", 2,
                  lambda: chains.channelizer_chain(4, device=CPU)),
}
# the segmented run: am_chain() from the carries after SEGMENTS[0] (one
# process), then over SEGMENTS[1:] time-sharded, 2 blocks a rank
SEGMENTS = ("raw", "raw2", "raw3")
SEGMENT_BLOCKS = 2
# how each compiled segment after the first takes its carries: the ones
# the call returned passed back, none (the call's own buffers), or the
# last rank's gathered (copied in)
SEGMENT_FORMS = ("passed", "none", "gathered")


def span(x: np.ndarray, axis: int, index: int, count: int) -> np.ndarray:
    """Part ``index`` of ``count`` equal parts of ``x`` along ``axis``."""
    n = x.shape[axis] // count
    return np.take(x, np.arange(index * n, (index + 1) * n), axis=axis)


def run_scenario(mode, x, nblocks, ops, tmesh, cmesh, grid):
    if mode == "time":
        off, length = local_time_span(tmesh, x.shape[-1])
        local = global_time_sharded(x[..., off:off + length], tmesh,
                                    x.shape[-1], device=CPU)
        return run_time_sharded(ops, tmesh, local, nblocks=nblocks,
                                device=CPU)
    if mode == "channel":
        c = cmesh.get_local_rank("c")
        return run_channel_sharded(ops, cmesh, span(x, -2, c,
                                                    cmesh["c"].size()),
                                   device=CPU)
    c, t = grid.get_local_rank("c"), grid.get_local_rank("t")
    local = span(span(x, -2, c, grid["c"].size()), -1, t, grid["t"].size())
    return run_grid_sharded(ops, grid, local, nblocks=nblocks, device=CPU)


def halo_outputs(data, group, rank):
    """The helpers on rows ``[2r, 2r + 2)`` of each stream of rows."""
    rows = slice(HALO_ROWS * rank, HALO_ROWS * (rank + 1))
    x = torch.from_numpy(data["halo_x"][rows])
    a = torch.from_numpy(data["halo_a"][rows])
    b = torch.from_numpy(data["halo_b"][rows])
    M = torch.from_numpy(data["halo_M"][rows])
    v = torch.from_numpy(data["halo_v"][rows])
    first = torch.zeros_like(x[0])
    A, B = halo.exclusive_affine_prefix(a, b, group)
    MA, Mc = halo.exclusive_matrix_affine_prefix(M, v, group)
    return {"halo.left": halo.left_halo(x, 5, fill=7, group=group),
            "halo.right": halo.right_shift_scalar(a, group),
            "halo.first": halo.substitute_first(x.clone(), first, group),
            "halo.A": A, "halo.B": B, "halo.MA": MA, "halo.Mc": Mc,
            "halo.row0": torch.tensor(halo.first_row(HALO_ROWS, group))}


def local_span(mode, x, tmesh, cmesh, grid):
    """This rank's part of ``x`` on the scenario's mesh."""
    if mode == "time":
        off, length = local_time_span(tmesh, x.shape[-1])
        return torch.from_numpy(np.ascontiguousarray(x[..., off:off + length]))
    if mode == "channel":
        return torch.from_numpy(span(x, -2, cmesh.get_local_rank("c"),
                                     cmesh["c"].size()))
    c, t = grid.get_local_rank("c"), grid.get_local_rank("t")
    return torch.from_numpy(np.ascontiguousarray(span(span(
        x, -2, c, grid["c"].size()), -1, t, grid["t"].size())))


def compile_scenario(mode, ops, x, nblocks, tmesh, cmesh, grid):
    """The compiled runner of ``mode`` on this rank's span ``x``."""
    if mode == "time":
        return compile_time_sharded(ops, tmesh, x, nblocks=nblocks,
                                    device=CPU)
    if mode == "channel":
        return compile_channel_sharded(ops, cmesh, x, device=CPU)
    return compile_grid_sharded(ops, grid, x, nblocks=nblocks, device=CPU)


def last_rank_carries(carries, group):
    """The carries of the group's last rank (the state after the stream's
    last block), on every rank: what enters the next segment."""
    return _unflatten(carries, iter([halo.gather_ranks(leaf, group)[-1]
                                     for leaf in flatten_carries(carries)]))


def segmented(data, tmesh, results):
    """``am_chain()`` over two segments of one stream, each time-sharded
    over every rank with the carries entering rank 0's first block
    (seeded by a run over an earlier recording): eagerly
    (``run_time_batched(group=)``, the last rank's carries threaded into
    the next segment), and through one compiled call for each of
    SEGMENT_FORMS."""
    group = tmesh.get_group("t")
    ops = chains.am_chain(device=CPU)
    seed, _ = run_time_batched(ops, data[SEGMENTS[0]], SEGMENT_BLOCKS,
                               return_carries=True, device=CPU)
    xs = [local_span("time", data[k], tmesh, None, None)
          for k in SEGMENTS[1:]]

    def keep(form, i, c, y):
        results[f"segment.{form}{i}"] = y.clone().numpy()
        results.update({f"segment.{form}{i}.carry{j}": leaf.clone().numpy()
                        for j, leaf in enumerate(flatten_carries(c))})

    cs = seed
    for i, x in enumerate(xs):
        c, y = run_time_batched(ops, x, SEGMENT_BLOCKS, carries=cs,
                                return_carries=True, device=CPU, group=group)
        keep("eager", i, c, y)
        cs = last_rank_carries(c, group)
    for form in SEGMENT_FORMS:
        call = compile_time_sharded(ops, tmesh, xs[0].clone(),
                                    nblocks=SEGMENT_BLOCKS, carries=seed,
                                    return_carries=True, device=CPU)
        c, y = call()
        keep(form, 0, c, y)
        cs = {"passed": c, "none": None,
              "gathered": last_rank_carries(c, group)}[form]
        c, y = call(xs[1], carries=cs)
        keep(form, 1, c, y)
        results[f"segment.{form}.copies"] = np.array([call.input_copies,
                                                      call.carry_copies])


def compiled(rank, world, data, tmesh, cmesh, grid, results):
    """Each COMPILED scenario eager and compiled on two input contents,
    the segmented run, then the compiled calls' refusals and agreement."""
    eager = {"time": lambda ops, x, nb: run_time_sharded(
                 ops, tmesh, x, nblocks=nb, device=CPU),
             "channel": lambda ops, x, nb: run_channel_sharded(
                 ops, cmesh, x, device=CPU),
             "grid": lambda ops, x, nb: run_grid_sharded(
                 ops, grid, x, nblocks=nb, device=CPU)}
    for name, (mode, key, nblocks, make) in COMPILED.items():
        ops = make()
        xs = [local_span(mode, data[k], tmesh, cmesh, grid)
              for k in (key, key + "2")]
        for i, x in enumerate(xs):
            results[f"{name}.eager{i}"] = eager[mode](ops, x, nblocks).numpy()
        call = compile_scenario(mode, ops, xs[0].clone(), nblocks, tmesh,
                                cmesh, grid)
        y = call()
        results[f"{name}.compiled0"] = y.clone().numpy()
        y = call(xs[1])
        results[f"{name}.compiled1"] = y.clone().numpy()
        results[f"{name}.input_copies"] = np.array(call.input_copies)
    segmented(data, tmesh, results)
    group = tmesh.get_group("t")
    # spans of unequal length: the compile-time shape check raises on
    # every rank, before any capture
    try:
        compile_time_sharded([Fir.filter(_fir_taps(), device=CPU)], tmesh,
                             torch.zeros(1024 + 64 * (rank == world - 1)),
                             device=CPU)
    except ValueError as e:
        results["compiled.unequal.error"] = np.array(str(e))
    # a gloo group's CUDA collectives go through the host: no capture
    results["capturable"] = np.array([
        halo.capturable(group, "cuda"), halo.capturable(group, "cpu"),
        halo.group_backend(group, "cuda") == "gloo"])
    # a step that raises on rank 2 only raises on every rank
    for what, bad in (("agree.ok", None), ("agree.fail", 2)):
        def step():
            if rank == bad:
                raise ArithmeticError(f"rank {rank} failed")
            return rank
        try:
            results[what] = np.array(halo.on_every_rank(step, group, CPU))
        except (ArithmeticError, RuntimeError) as e:
            results[what] = np.array(f"{type(e).__name__}: {e}")


def sharded(rank, world, inp, out):
    data = np.load(inp)
    tmesh = time_mesh(device_type=CPU)
    cmesh = make_mesh((world,), ("c",), CPU)
    grid = channel_time_mesh(2, world // 2, CPU)
    results = {}
    for name, (mode, key, nblocks, make) in SCENARIOS.items():
        try:
            y = run_scenario(mode, data[key], nblocks, make(), tmesh, cmesh,
                             grid)
        except ValueError as e:
            results[f"{name}.error"] = np.array(str(e))
        else:
            results[name] = y.numpy()
    for k, t in halo_outputs(data, tmesh.get_group("t"), rank).items():
        results[k] = t.numpy()
    # spans of unequal length: the shape check raises on every rank
    try:
        run_time_sharded([Fir.filter(_fir_taps(), device=CPU)], tmesh,
                         torch.zeros(1024 + 64 * (rank == world - 1)),
                         device=CPU)
    except ValueError as e:
        results["unequal.error"] = np.array(str(e))
    compiled(rank, world, data, tmesh, cmesh, grid, results)
    np.savez(out, **results)


def multihost(rank, world, inp, out):
    """The counterpart of tests/multihost_worker.py: each rank reads only
    its span of each global block of the recording."""
    mesh = time_mesh(device_type=CPU)
    n_global = world * MULTIHOST_ROWS * MULTIHOST_ROW
    off, length = local_time_span(mesh, n_global)
    if (off, length) != (rank * n_global // world, n_global // world):
        raise RuntimeError(f"rank {rank}: span {(off, length)}")
    ops = chains.fm_chain(device=CPU)
    results = {}
    for i, blk in enumerate(host_block_iterator(inp, mesh, n_global)):
        results[f"span{i}"] = blk
        y = run_time_sharded(ops, mesh, global_time_sharded(
            blk, mesh, n_global, device=CPU), nblocks=MULTIHOST_ROWS,
            device=CPU)
        joined = gather_time_sharded(y, mesh)
        if (joined is None) != (rank != 0):
            raise RuntimeError(f"rank {rank}: gathered {joined is not None}")
        if joined is not None:
            results[f"block{i}"] = joined.numpy()
    np.savez(out, **results)


def spawn(mode, world, inp, tmp, timeout=TIMEOUT_S):
    """Run ranks ``0..world-1`` of MODE as processes to their end, each
    under ``timeout``, the store and outputs in the directory ``tmp``;
    returns the ranks' output files.  A rank that fails or hangs fails the
    run, and every rank still running is killed first.  (Called by the
    tests.)"""
    store = tmp / "store"
    outs = [tmp / f"rank{r}.npz" for r in range(world)]
    env = dict(os.environ, PYTHONPATH=str(HERE.parent), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(HERE / "torch_sharded_worker.py"), mode, str(r),
         str(world), str(store), str(inp), str(outs[r])], cwd=HERE.parent,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    rcs = [p.returncode for p in procs]
    if rcs != [0] * world:
        raise AssertionError(f"ranks exited {rcs}:\n" + "\n".join(logs))
    return outs


def main(argv):
    mode, rank, world, store, inp, out = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    init_distributed("gloo", init_method=f"file://{store}",
                     world_size=world, rank=rank)
    try:
        {"sharded": sharded, "multihost": multihost}[mode](rank, world, inp,
                                                           out)
    finally:
        torch.distributed.destroy_process_group()
    print(f"rank {rank} of {world}: OK", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
