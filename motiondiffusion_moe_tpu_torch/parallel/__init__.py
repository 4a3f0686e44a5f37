"""Multi-device training: the data and expert axes of the JAX package's
``parallel/`` over ``torch.distributed``, one process per device (data
parallelism and ZeRO-1, ``data_parallel.py``; the ``(data, expert)`` mesh
and the expert shards, ``mesh.py``; the expert-parallel MoE FFN,
``moe_parallel.py``). The model, seq and pipe axes (``mesh.py``'s other
axes, ``pipeline_parallel.py``) are not ported."""

from motiondiffusion_moe_tpu_torch.parallel.distributed import (  # noqa: F401
    initialize_distributed,
    is_primary,
    local_batch_slice,
    barrier,
)
from motiondiffusion_moe_tpu_torch.parallel.data_parallel import (  # noqa: F401
    DataGroup,
    FlatPartition,
    Sharded,
)
from motiondiffusion_moe_tpu_torch.parallel.mesh import (  # noqa: F401
    ExpertMesh,
    is_expert_param,
    make_mesh,
    shard_experts,
)
