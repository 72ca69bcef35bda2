"""Run one cell of the port's benchmark on the cards of this machine.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (``workloads/<cell>.json``) names
its configuration (``configs/<config>.json``: the chain's builder and
arguments, the deployment its plain reference reads), its traffic (the
recording a call decodes, blocks, calls in flight, sharding), its signal
generator (``signals/<name>.py``) and the per-layer metrics it reports
(``metrics/<metric>.py``).  A run builds the chain of ``sdr_tpu_torch``,
makes the recording on the card from the seed, compiles the call
(``compile_time_batched``, or ``compile_time_sharded`` over the cards of
a sharded cell, one process a card), warms it up and measures it for
``--seconds``; then it holds the outputs of calls made in the window
against the plain reference (``reference/<config>.py``) and prints the
result as the last line of standard output.  ``--trace 1`` adds a
profiled window after the measured one and reports the per-layer metrics.

A run fails (exit code other than 0, no result) without a card, with
fewer cards than the cell asks for, outside a checkout of the repository,
and where ``jax``, ``jaxlib``, ``flax`` or ``sdr_tpu`` is loaded.
"""

from __future__ import annotations

import time

_T_HARNESS = time.time()

import argparse
import gc
import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "sdr_tpu")
STOP_MARGIN = 32        # calls a sharded window runs past rank 0's deadline
STOP_POLL = 8           # calls between a rank's looks for that stop
RUN_LIMIT_S = 330       # a sharded run's ranks are ended after this


def process_start() -> float:
    """Wall-clock time this process started (``/proc``), or the harness's
    first line where that cannot be read."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                    .split()[19])
        btime = next(int(line.split()[1]) for line in
                     Path("/proc/stat").read_text().splitlines()
                     if line.startswith("btime "))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return _T_HARNESS


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark may not load,
    each compared whole (``sdr_tpu_torch`` is not ``sdr_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_json(kind: str, name: str) -> dict:
    path = ROOT / kind / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"portbench: no {kind[:-1]} {name!r} ({path})")
    return json.loads(path.read_text())


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` as a module (a metric's name may hold dots)."""
    path = ROOT / kind / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"portbench: no {kind} module {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}.{name.replace('.', '__')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload and what it names, found by name under portbench/."""

    def __init__(self, name: str):
        self.name = name
        self.spec = load_json("workloads", name)
        self.cfg = load_json("configs", self.spec["config"])
        self.traffic = self.spec["traffic"]
        self.programme = self.cfg["programmes"][self.traffic["programme"]]
        self.signal = load_module("signals", self.traffic["signal"])
        self.reference = load_module("reference", self.cfg["reference"])
        self.metrics = {m: load_module("metrics", m)
                        for m in self.spec["metrics"]}
        self.chips = int(self.spec["chips"])
        if self.chips > 1 and self.traffic.get("sharding") != "time":
            raise SystemExit(f"portbench: {name} asks for {self.chips} "
                             "cards; only time sharding runs on several")

    @property
    def block(self) -> int:
        """Input items a block: bytes of u8 I/Q or complex samples."""
        t = self.traffic
        return t["block_bytes"] if "block_bytes" in t else t["block_len"]

    @property
    def samples_per_call(self) -> int:
        """Complex input samples one call decodes (on one rank)."""
        n = self.traffic["blocks"] * self.block
        return n // 2 if self.cfg["input"] == "u8" else n

    def make_input(self, seed: int, rank: int = 0, world: int = 1,
                   device="cuda"):
        return self.signal.make(self.traffic, self.cfg, seed, rank, world,
                                device)

    def build(self, device="cuda"):
        from sdr_tpu_torch.apps import chains
        return getattr(chains, self.cfg["builder"])(
            device=device, **self.programme["kwargs"])

    def expected(self, seed: int, x, rank: int = 0, world: int = 1,
                 dtype=None):
        """The reference's output for rank ``rank``'s recording ``x``: the
        stream from rest over the ranks' recordings joined; a rank after
        the first runs it from ``halo`` items of the rank before it
        (longer than the chain's memory), whose outputs it drops."""
        import torch
        dtype = dtype or torch.float64
        run = self.reference.run
        if rank == 0:
            return run(self.cfg, self.programme, x, self.block, dtype)
        halo = self.traffic["halo"]
        before = self.make_input(seed, rank - 1, world, x.device)[-halo:]
        y = run(self.cfg, self.programme, torch.cat([before, x]),
                self.block, dtype)
        drop = y.shape[-1] * halo // (halo + x.shape[-1])
        return y[..., drop:]


def gap(y, ref) -> float:
    """The widest gap between the program's output and the reference's,
    as a share of the reference's peak; infinite where the shapes differ
    or a sample is not finite."""
    import torch
    if tuple(y.shape) != tuple(ref.shape):
        return float("inf")
    d = (y.to(torch.float64) - ref.to(torch.float64)).abs()
    if not bool(torch.isfinite(d).all()):
        return float("inf")
    return float(d.max() / ref.abs().max())


def sample_indices(seed: int, spec: dict) -> list:
    """Calls whose outputs are copied out in the window, drawn from the
    seed among the first ``sample_before`` (the last call is read too)."""
    from portbench.signals._tones import seeds
    w = spec["window"]
    rng = seeds(seed, 5)
    return sorted(int(i) for i in rng.choice(
        w["sample_before"], w["sample_calls"] - 1, replace=False))


def card_power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def _stopper(rank: int, rdzv: Path, seconds: float):
    """A sharded window's end, the same call on every rank: rank 0 at its
    deadline names the call ``STOP_MARGIN`` later in a file the others
    read."""
    path = rdzv / "stop"
    state = {"deadline": None, "n": None}

    def stop(i: int) -> bool:
        if state["deadline"] is None:
            state["deadline"] = time.perf_counter() + seconds
        if state["n"] is None:
            if rank == 0 and time.perf_counter() >= state["deadline"]:
                state["n"] = i + STOP_MARGIN
                tmp = path.with_suffix(".tmp")
                tmp.write_text(str(state["n"]))
                os.replace(tmp, path)
            elif rank != 0 and i % STOP_POLL == 0 and path.exists():
                state["n"] = int(path.read_text())
                if i > state["n"]:
                    raise RuntimeError(f"rank {rank} at call {i} passed the "
                                       f"stop at {state['n']}")
        return state["n"] is not None and i >= state["n"]

    return stop


def run_rank(cell: Cell, seed: int, seconds: float, trace: bool,
             rank: int = 0, world: int = 1, rdzv: Path | None = None,
             phases: dict | None = None):
    """One rank's run: set-up, window, outputs checked; returns its record
    (JSON-ready).  ``phases``: set-up seconds already spent, by name."""
    phases = dict(phases or {})
    t = time.time()
    import torch
    from sdr_tpu_torch.kernels import KERNELS
    from sdr_tpu_torch.kernels._build import build_all
    from sdr_tpu_torch.parallel import sharded
    from portbench import timing
    phases["import"] = time.time() - t

    t = time.time()
    torch.cuda.set_device(rank)
    device = torch.device("cuda", rank)
    torch.zeros(1, device=device)
    torch.cuda.synchronize()
    phases["device"] = time.time() - t

    t = time.time()
    first_run = any(not k.library_path().exists() for k in KERNELS)
    build_all(KERNELS)
    for k in KERNELS:
        k.lib()
    phases["kernels"] = time.time() - t

    mesh = None
    if world > 1:
        t = time.time()
        from sdr_tpu_torch.parallel.mesh import time_mesh
        from sdr_tpu_torch.parallel.multihost import init_distributed
        init_distributed(init_method=f"file://{rdzv / 'store'}",
                         world_size=world, rank=rank)
        mesh = time_mesh(world)
        phases["group"] = time.time() - t

    t = time.time()
    x = cell.make_input(seed, rank, world, device)
    torch.cuda.synchronize()
    phases["synthesis"] = time.time() - t
    gc.collect()
    torch.cuda.reset_peak_memory_stats(device)

    t = time.time()
    ops = cell.build(device)
    phases["chain"] = time.time() - t

    t = time.time()
    blocks = cell.traffic["blocks"]
    if mesh is None:
        call = sharded.compile_time_batched(ops, x, blocks, device=device)
    else:
        call = sharded.compile_time_sharded(ops, mesh, x, nblocks=blocks,
                                            device=device)
    torch.cuda.synchronize()
    phases["capture"] = time.time() - t
    peak = torch.cuda.max_memory_allocated(device)

    t = time.time()
    y = call()
    held = {i: torch.empty_like(y) for i in sample_indices(seed, cell.spec)}
    kept = sum(b.numel() * b.element_size() for b in held.values())
    for _ in range(cell.spec["window"]["warmup_calls"]):
        y = call()
        for b in held.values():
            b.copy_(y)
    torch.cuda.synchronize()
    phases["warmup"] = time.time() - t

    if world > 1:
        import torch.distributed as dist
        dist.barrier()
        stop = _stopper(rank, rdzv, seconds)
    else:
        stop = None
    t_first = time.time()
    w = timing.window(call, seconds, cell.traffic["in_flight"], held, stop)
    peak = max(peak, torch.cuda.max_memory_allocated(device) - kept)
    held[w.calls - 1] = w.last.clone()
    rec = {"rank": rank, "calls": w.calls, "t0": w.t0, "t1": w.t1,
           "t_first": t_first, "spans_ms": w.spans_ms,
           "peak_bytes": int(peak), "first_run": first_run,
           "phases": phases, "forbidden": forbidden_modules(),
           "kind": torch.cuda.get_device_name(device)}
    if trace:
        rec.update(_trace(cell, call, w, timing))
    w.last = None
    del call, ops, y
    gc.collect()
    torch.cuda.empty_cache()

    t = time.time()
    ref = cell.expected(seed, x, rank, world)
    rec["gaps"] = {str(i): gap(b, ref) for i, b in held.items()}
    torch.cuda.synchronize()
    rec["reference_s"] = time.time() - t
    if world > 1:
        import torch.distributed as dist
        dist.destroy_process_group()
    return rec


def _trace(cell: Cell, call, w, timing) -> dict:
    """The profiled window, the kernel count and the per-layer metrics of
    this rank."""
    import sdr_tpu_torch
    prof = timing.profiled_window(call, cell.spec["window"]["trace_calls"],
                                  cell.traffic["in_flight"])
    counted = timing.kernel_count(call)
    y = w.last
    in_bytes = call.x.numel() * call.x.element_size()
    rec = {"profile": prof, "enqueue_ms": w.enqueue_ms,
           "kernel_count": counted,
           "port_kernels": timing.port_kernel_names(
               Path(sdr_tpu_torch.__file__).parent / "csrc"),
           "geometry": {"bytes_in": in_bytes,
                        "bytes_out": y.numel() * y.element_size(),
                        "traffic": cell.traffic, "config": cell.cfg}}
    values = {m: mod.read(rec) for m, mod in cell.metrics.items()}
    lo, hi = prof["window"]
    busy = timing.busy_us(prof["device"], lo, hi)
    ops = {}
    for n, s, e in prof["device"]:
        ops[n] = ops.get(n, 0.0) + (e - s) * 1e-6
    gaps = []
    for a, b in timing.idle_gaps(prof["device"], lo, hi):
        label = next((n for n, s, e in prof["host"] if s <= a < e),
                     "python")
        gaps.append([label, (b - a) * 1e-6])
    return {"metrics": values, "busy_s": busy * 1e-6,
            "window_s": (hi - lo) * 1e-6,
            "device_ops": sorted(([n[:160], s] for n, s in ops.items()),
                                 key=lambda r: -r[1])[:10],
            "idle_gaps": sorted(gaps, key=lambda r: -r[1])[:10]}


def combine(cell: Cell, recs: list, trace: bool, t_start: float) -> tuple:
    """The ranks' records -> (the result line, the checks)."""
    from portbench.timing import quantile
    limit = cell.spec["limits"]["out_gap"]
    gaps = [g for r in recs for g in r["gaps"].values()]
    worst = max(gaps)
    calls = recs[0]["calls"]
    if any(r["calls"] != calls for r in recs):
        raise RuntimeError("the ranks made different numbers of calls")
    t0, t1 = min(r["t0"] for r in recs), max(r["t1"] for r in recs)
    spans = [max(r["spans_ms"][i] for r in recs) for i in range(calls)]
    peak = max(r["peak_bytes"] for r in recs)
    if trace:
        metrics = {}
        for m, mod in cell.metrics.items():
            got = [r["metrics"][m] for r in recs
                   if r["metrics"][m] is not None]
            if not got:
                continue
            across = getattr(mod, "ACROSS", max)
            v = statistics.fmean(got) if across == "mean" else across(got)
            metrics[m] = {"value": v, "unit": mod.UNIT}
    else:
        metrics = {
            "input_rate": {"value": calls * len(recs) * cell.samples_per_call
                           / (t1 - t0) / 1e9, "unit": "Gsamples/s"},
            "call_ms_p95": {"value": quantile(spans, 0.95), "unit": "ms"},
            "peak_mem": {"value": peak / 1e9, "unit": "GB"},
            "setup_s": {"value": recs[0]["t_first"] - t_start, "unit": "s"},
        }
    line = {"correct": worst <= limit, "attempted": calls * len(recs),
            "failed": sum(g > limit for g in gaps), "metrics": metrics,
            "device": {"platform": "gpu", "kind": recs[0]["kind"],
                       "count": len(recs), "memory_peak_bytes": peak}}
    if trace:
        line["device"]["busy_s"] = statistics.fmean(r["busy_s"]
                                                    for r in recs)
        line["device"]["window_s"] = statistics.fmean(r["window_s"]
                                                      for r in recs)
        line["breakdown"] = {"device_ops": recs[0]["device_ops"],
                             "idle_gaps": recs[0]["idle_gaps"]}
    return line, {"out_gap": {"value": worst, "limit": limit}}


def _report(cell: Cell, recs: list, t_start: float) -> None:
    r0 = recs[0]
    split = ", ".join(f"{k} {v:.3f}" for k, v in r0["phases"].items())
    first = " (first run in this checkout: the kernels were built)" \
        if any(r["first_run"] for r in recs) else ""
    print(f"portbench {cell.name}: {card_power_limit()}", file=sys.stderr)
    print(f"setup_s split, rank 0: {split}; to the first timed call "
          f"{r0['t_first'] - t_start:.3f} s{first}; reference "
          f"{max(r['reference_s'] for r in recs):.3f} s after the window",
          file=sys.stderr)
    from portbench.timing import quantile
    spans = r0["spans_ms"]
    q = "/".join(f"{quantile(spans, p):.4f}" for p in (0.0, 0.5, 0.95, 0.99,
                                                      1.0))
    slow = [max(range(len(r["spans_ms"])), key=r["spans_ms"].__getitem__)
            for r in recs]
    print(f"window: {r0['calls']} calls a rank in {r0['t1'] - r0['t0']:.3f}"
          f" s; rank 0's spans min/p50/p95/p99/max {q} ms; the slowest "
          f"call of each rank {slow}; sampled calls "
          f"{sorted(int(i) for i in r0['gaps'])}", file=sys.stderr)


def _spawn_ranks(cell: Cell, args, rdzv: Path) -> list:
    env = dict(os.environ, NCCL_SHM_DISABLE="1")
    procs = []
    for r in range(cell.chips):
        cmd = [sys.executable, "-m", "portbench.run", "--workload",
               cell.name, "--seed", str(args.seed), "--seconds",
               str(args.seconds), "--trace", str(int(args.trace)),
               "--rank", str(r), "--rdzv", str(rdzv)]
        procs.append(subprocess.Popen(cmd, env=env, stdout=sys.stderr))
    return procs


def _wait_ranks(procs, deadline: float) -> bool:
    """Wait for every rank; where one fails or the time runs out, end the
    others.  True when all ended with 0."""
    ok = True
    while any(p.poll() is None for p in procs):
        if any(p.returncode not in (None, 0) for p in procs) \
                or time.time() > deadline:
            ok = False
            break
        time.sleep(0.2)
    for p in procs:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            p.wait(timeout=20)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
    return ok and all(p.returncode == 0 for p in procs)


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--rdzv", type=Path, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    t = time.time()
    import torch
    phases = {"python": _T_HARNESS - t_start, "torch": time.time() - t}
    t = time.time()
    cell = Cell(args.workload)
    phases["harness"] = time.time() - t

    if args.rank is not None:           # one rank of a sharded run
        rec = run_rank(cell, args.seed, args.seconds, bool(args.trace),
                       args.rank, cell.chips, args.rdzv, phases)
        out = args.rdzv / f"rank{args.rank}.json"
        out.with_suffix(".tmp").write_text(json.dumps(rec))
        os.replace(out.with_suffix(".tmp"), out)
        return 0

    t = time.time()
    if not torch.cuda.is_available():
        print("portbench: no CUDA card; the benchmark runs only on one",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} cards, this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    phases["cards"] = time.time() - t
    if cell.chips == 1:
        recs = [run_rank(cell, args.seed, args.seconds, bool(args.trace),
                         phases=phases)]
    else:
        rdzv = Path(tempfile.mkdtemp(prefix="portbench-"))
        try:
            procs = _spawn_ranks(cell, args, rdzv)
            if not _wait_ranks(procs, time.time() + RUN_LIMIT_S):
                print("portbench: a rank failed; no result", file=sys.stderr)
                return 1
            recs = [json.loads((rdzv / f"rank{r}.json").read_text())
                    for r in range(cell.chips)]
        finally:
            shutil.rmtree(rdzv, ignore_errors=True)
    found = sorted(set(forbidden_modules()).union(
        *(r["forbidden"] for r in recs)))
    if found:
        print(f"portbench: loaded modules it may not load: {found}; no "
              "result", file=sys.stderr)
        return 1
    _report(cell, recs, t_start)
    line, checks = combine(cell, recs, bool(args.trace), t_start)
    from portbench.timing import emit
    emit(line, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
