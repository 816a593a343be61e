"""Multi-device DSMGP on ``torch.distributed`` (counterpart of
``deepstructuredmixtures_tpu/parallel``): expert parallelism over the
leaf axis (:mod:`.mesh`) and the row-sharded distributed Cholesky of one
giant expert (:mod:`.dist_chol`), over a ``DeviceMesh`` (:mod:`.comm`).

Every rank runs the same program (SPMD): start the ranks with
``torchrun`` or ``torch.multiprocessing.spawn``, call
``torch.distributed.init_process_group`` on each, then
``make_mesh()``. ``python -m deepstructuredmixtures_tpu_torch.parallel.dryrun
--nproc N [--device cpu]`` checks the whole surface against one device.
"""
from .mesh import (
    make_mesh,
    shard_batch,
    pad_leaves,
    make_sharded_mll_fn,
    make_sharded_train_step,
    make_sharded_routed_predict,
    sharded_bucketed_streamed_predict,
    sharded_fit,
)
from .dist_chol import (
    sharded_cholesky,
    sharded_solve_lower,
    sharded_solve_lower_t,
    sharded_gp_fit,
)

__all__ = [
    "make_mesh",
    "shard_batch",
    "pad_leaves",
    "make_sharded_mll_fn",
    "make_sharded_train_step",
    "make_sharded_routed_predict",
    "sharded_bucketed_streamed_predict",
    "sharded_fit",
    "sharded_cholesky",
    "sharded_solve_lower",
    "sharded_solve_lower_t",
    "sharded_gp_fit",
]
