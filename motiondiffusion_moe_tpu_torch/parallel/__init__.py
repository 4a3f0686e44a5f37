"""Multi-device training and generation: the data, seq, expert and model
axes of the JAX package's ``parallel/`` over ``torch.distributed``, one
process per device (data parallelism and ZeRO-1, ``data_parallel.py``; the
``(data, seq, expert, model)`` mesh, the expert shards, the Megatron FFN
split and the seq ranks' frames, ``mesh.py``; the expert-parallel and
tensor-parallel MoE FFN and the row-parallel sums, ``moe_parallel.py``; the
launch and the job channel of serving and evaluation, ``distributed.py``).
The pipe axis (``pipeline_parallel.py``) is not ported (ROADMAP item
6c2)."""

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
from motiondiffusion_moe_tpu_torch.parallel.mesh import (  # noqa: F401
    ExpertMesh,
    generation_mesh,
    is_expert_param,
    launch_generation,
    make_mesh,
    model_dim,
    shard_params,
)
