"""Readings that set a cell's output limit, many seeds in one process.

    python3 -m portbench.control --workload <cell> --seeds <n> [<n> ...] [--rank r]

For each seed it makes the cell's recording on the card, runs the cell's
compiled call on it (the timed path at the timed size: the call is
compiled once, each seed's recording copied into its input), and prints
one JSON line: ``program``, the program's widest gap to the plain
reference as a share of the reference's peak (the lower reading), and
``control``, the same gap of the reference computed in bfloat16, the
precision below the configuration's float32, put in the program's place
(the upper reading).  ``--rank r`` reads a sharded cell's rank ``r``: the
control over its span of the joined recording (the program's sharded
call runs only in ``portbench.run``, every rank at once).  The benchmark's
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--rank", type=int, default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA card", file=sys.stderr)
        return 2
    from portbench.run import Cell, gap
    cell = Cell(args.workload)
    device = torch.device("cuda", 0)
    rank = 0 if args.rank is None else args.rank
    world = cell.chips if args.rank is not None else 1
    call = None
    for seed in args.seeds:
        t = time.time()
        x = cell.make_input(seed, rank, world, device)
        row = {"workload": cell.name, "seed": seed, "rank": rank}
        if args.rank is None:
            from sdr_tpu_torch.parallel.sharded import compile_time_batched
            if call is None:
                call = compile_time_batched(cell.build(device), x,
                                            cell.traffic["blocks"],
                                            device=device)
            for _ in range(3):
                y = call(x)
            y = y.clone()
        ref = cell.expected(seed, x, rank, world)
        if args.rank is None:
            row["program"] = gap(y, ref)
            del y
        low = cell.expected(seed, x, rank, world, torch.bfloat16)
        row["control"] = gap(low, ref)
        del low, ref, x
        torch.cuda.empty_cache()
        row["seconds"] = round(time.time() - t, 3)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
