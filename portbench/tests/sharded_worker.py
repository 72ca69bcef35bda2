"""One CPU rank of the sharded cell for test_portbench_reference.py:

    python sharded_worker.py <rank> <dir> <seed> <traffic json> <fault>

joins a four-rank gloo group through a file in ``dir``, runs the cell's
compiled sharded call (``compile_time_sharded``) on its span of the
recording, and writes its output's gap to the reference into
``dir/rank<rank>.json``.  ``fault`` 'exchange' leaves the exchange between
ranks out: each rank's first block takes its warm-up history."""

import json
import sys
from pathlib import Path

import torch
import torch.distributed as dist


def main():
    rank, where, seed = int(sys.argv[1]), Path(sys.argv[2]), int(sys.argv[3])
    small, fault = json.loads(sys.argv[4]), sys.argv[5]
    torch.set_num_threads(1)
    from portbench import run
    from sdr_tpu_torch.parallel import halo
    from sdr_tpu_torch.parallel.mesh import time_mesh
    from sdr_tpu_torch.parallel.sharded import compile_time_sharded
    if fault == "exchange":
        halo._from_left = lambda row, group: None
    dist.init_process_group("gloo", init_method=f"file://{where}/store",
                            world_size=4, rank=rank)
    cell = run.Cell("fm_broadcast.mono_x4")
    cell.traffic = dict(cell.traffic, **small)
    mesh = time_mesh(4, device_type="cpu")
    x = cell.make_input(seed, rank, 4, "cpu")
    call = compile_time_sharded(cell.build("cpu"), mesh, x,
                                nblocks=cell.traffic["blocks"], device="cpu")
    y = call().clone()
    ref = cell.expected(seed, x, rank, 4)
    (where / f"rank{rank}.json").write_text(json.dumps(
        {"gap": run.gap(y, ref)}))
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
