"""Multi-device training: the data axis of the JAX package's ``parallel/``
(data parallelism and ZeRO-1 over ``torch.distributed``, one process per
device). The expert, model, seq and pipe axes (``mesh.py``'s other axes,
``moe_parallel.py``, ``pipeline_parallel.py``) are not ported."""

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
    data_group,
)
