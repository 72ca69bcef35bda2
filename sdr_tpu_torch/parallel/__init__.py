"""Device meshes, halo exchange and block-parallel / sharded execution of
stream-op chains, on one card or over ``torch.distributed`` ranks."""

from sdr_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    time_mesh,
    channel_time_mesh,
)
from sdr_tpu_torch.parallel.halo import (  # noqa: F401
    left_halo,
    right_shift_scalar,
    exclusive_affine_prefix,
    capturable,
)
from sdr_tpu_torch.parallel.sharded import (  # noqa: F401
    time_sharded_fn,
    run_time_sharded,
    run_time_batched,
    run_channel_sharded,
    run_grid_sharded,
    compile_time_batched,
    compile_time_sharded,
    compile_channel_sharded,
    compile_grid_sharded,
)
from sdr_tpu_torch.parallel import mesh  # noqa: F401
from sdr_tpu_torch.parallel.multihost import (  # noqa: F401
    init_distributed,
    local_time_span,
    global_time_sharded,
    gather_time_sharded,
    host_block_iterator,
)
