"""Scale-out over torch.distributed ranks: sequence replicas x feature
blocks (multichip.py), the VIO_* bootstrap and host-local feeding
(distributed.py), one rank's entry point (worker.py) and the multi-rank
dry run (dryrun.py). The port's counterpart of vio_msckf_tpu/parallel/."""

from vio_msckf_torch.parallel.multichip import (
    make_mesh,
    make_multichip_filter_step,
    make_multichip_engine_step,
    shard_batch,
    tiny_config,
)
from vio_msckf_torch.parallel.distributed import (
    initialize_from_env,
    make_global_mesh,
    make_global_batch,
    local_rows,
    collect_local_outputs,
)

__all__ = [
    "make_mesh",
    "make_multichip_filter_step",
    "make_multichip_engine_step",
    "shard_batch",
    "tiny_config",
    "initialize_from_env",
    "make_global_mesh",
    "make_global_batch",
    "local_rows",
    "collect_local_outputs",
]
