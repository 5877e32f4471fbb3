"""Multi-process training on a ``(data, model)`` mesh: the counterpart of
``dinox_tpu.parallel`` (module 13a; pipeline and expert parallelism are
module 13b)."""

from dinox_torch.parallel.mesh import (
    DATA_AXIS,
    EXPERT_AXIS,
    MODEL_AXIS,
    Mesh,
    batch_rows,
    gather_state,
    host_barrier,
    init_distributed,
    make_mesh,
    shard_state,
    tp_param_spec,
)

__all__ = ["DATA_AXIS", "EXPERT_AXIS", "MODEL_AXIS", "Mesh", "batch_rows", "gather_state",
           "host_barrier", "init_distributed", "make_mesh", "shard_state", "tp_param_spec"]
