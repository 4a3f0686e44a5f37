"""Multi-device training and generation: the data, seq, pipe, expert and
model axes of the JAX package's ``parallel/`` over ``torch.distributed``,
one process per device (data parallelism and ZeRO-1, ``data_parallel.py``;
the ``(data, seq, pipe, expert, model)`` mesh, the expert shards, the
Megatron FFN split, the seq ranks' frames and the pipe stages' blocks,
``mesh.py``; the GPipe ring of the pipe stages, ``pipeline_parallel.py``;
the expert-parallel and tensor-parallel MoE FFN and the row-parallel sums,
``moe_parallel.py``; the launch and the job channel of serving and
evaluation, ``distributed.py``)."""

from motiondiffusion_moe_tpu_torch.parallel.distributed import (  # noqa: F401
    JobLeader,
    barrier,
    broadcast_job,
    follow_jobs,
    in_turn,
    initialize_distributed,
    is_primary,
    local_batch_slice,
)
from motiondiffusion_moe_tpu_torch.parallel.data_parallel import (  # noqa: F401
    DataGroup,
    FlatPartition,
    Sharded,
)
from motiondiffusion_moe_tpu_torch.parallel.pipeline_parallel import (  # noqa: F401,E501
    format_pp_memory_report,
    gpipe,
    pp_num_microbatches,
    pp_stage_memory_report,
    validate_pp_layout,
)
from motiondiffusion_moe_tpu_torch.parallel.mesh import (  # noqa: F401
    ExpertMesh,
    generation_mesh,
    is_expert_param,
    launch_generation,
    make_mesh,
    model_dim,
    shard_params,
)
