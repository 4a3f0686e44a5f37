"""Motion datasets, normalization and batching (host-side numpy)."""

from motiondiffusion_moe_tpu_torch.data.normalizer import (  # noqa: F401
    MotionNormalizer,
)
from motiondiffusion_moe_tpu_torch.data.dataset import (  # noqa: F401
    Text2MotionDataset,
    SyntheticText2MotionDataset,
    parse_text_annotation,
)
from motiondiffusion_moe_tpu_torch.data.loader import (  # noqa: F401
    DistributedSampler,
    DataLoader,
)
