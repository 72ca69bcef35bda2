"""Where the time of the block-parallel FM chain goes on the card.

    python -m sdr_tpu_torch.profile_fm

Runs ``run_time_batched`` over the main path's 32 blocks of 10,485,760
bytes of random u8 IQ (the work does not depend on the data) once to warm
up, then in one process:

1. ``REPS`` calls unprofiled, each between CUDA events: the call's span on
   the device's clock, host gaps included;
2. ``REPS`` calls under ``torch.profiler``: the device time of each kernel
   by name and their sum (busy), and the profiled wall time, which carries
   the profiler's own overhead;
3. one call under ``cProfile``: the host functions that take the most
   time.

The idle share is ``1 - busy / span``, busy from 2 and the unprofiled
median span from 1.  Needs a CUDA GPU.
"""

from __future__ import annotations

import cProfile
import io
import json
import pstats
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from sdr_tpu_torch.apps.chains import fm_chain
from sdr_tpu_torch.parallel.sharded import run_time_batched

ROWS, ROW_BYTES = 32, 10_485_760      # the block-parallel main path
REPS = 20


def main() -> int:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    ops = fm_chain()
    raw = torch.randint(0, 256, (ROWS * ROW_BYTES,), dtype=torch.uint8,
                        device="cuda")
    run_time_batched(ops, raw, ROWS)
    torch.cuda.synchronize()

    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(REPS)]
    for a, b in ev:
        a.record()
        run_time_batched(ops, raw, ROWS)
        b.record()
    torch.cuda.synchronize()
    span = float(np.median([a.elapsed_time(b) for a, b in ev]))

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(REPS):
            run_time_batched(ops, raw, ROWS)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / REPS * 1e3
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            kernels[e.key] = (e.self_device_time_total / 1e3 / REPS,
                              e.count / REPS)
    busy = sum(ms for ms, _ in kernels.values())

    pr = cProfile.Profile()
    pr.enable()
    run_time_batched(ops, raw, ROWS)
    torch.cuda.synchronize()
    pr.disable()
    s = io.StringIO()
    pstats.Stats(pr, stream=s).sort_stats("cumulative").print_stats(15)

    print(f"card: {card}")
    for name, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0]):
        print(f"  {ms:10.4f} ms  x{n:g}  {name[:100]}")
    print(s.getvalue())
    print(json.dumps({"rows": ROWS, "row_bytes": ROW_BYTES, "reps": REPS,
                      "span_ms": span, "device_busy_ms": busy,
                      "idle_share": 1 - busy / span,
                      "profiled_wall_ms": wall,
                      "kernels_ms": {k: v[0] for k, v in kernels.items()},
                      "card": card}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
