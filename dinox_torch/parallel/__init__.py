"""Multi-process training on a ``(data, model[, expert])`` mesh: the
counterpart of ``dinox_tpu.parallel`` (modules 13a and 13b's data, tensor,
sequence and expert parallelism; the pipeline is module 13b's last part)."""

from dinox_torch.parallel.mesh import (
    DATA_AXIS,
    EXPERT_AXIS,
    MODEL_AXIS,
    Mesh,
    batch_rows,
    ep_param_spec,
    gather_state,
    host_barrier,
    init_distributed,
    make_mesh,
    model_group_share,
    shard_model,
    shard_state,
    tp_param_spec,
)

__all__ = ["DATA_AXIS", "EXPERT_AXIS", "MODEL_AXIS", "Mesh", "batch_rows", "ep_param_spec",
           "gather_state", "host_barrier", "init_distributed", "make_mesh", "model_group_share",
           "shard_model", "shard_state", "tp_param_spec"]
