"""Multi-process training on a ``(data, model[, expert])`` mesh, or a
``(data, pipe)`` one: the counterpart of ``dinox_tpu.parallel`` (modules 13a
and 13b: data, tensor, sequence, expert and pipeline parallelism)."""

from dinox_torch.parallel.mesh import (
    DATA_AXIS,
    EXPERT_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
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
from dinox_torch.parallel.pipeline import make_pp_mesh, pipeline_run_blocks

__all__ = ["DATA_AXIS", "EXPERT_AXIS", "MODEL_AXIS", "PIPE_AXIS", "Mesh", "batch_rows", "ep_param_spec",
           "gather_state", "host_barrier", "init_distributed", "make_mesh", "make_pp_mesh",
           "model_group_share", "pipeline_run_blocks", "shard_model", "shard_state", "tp_param_spec"]
