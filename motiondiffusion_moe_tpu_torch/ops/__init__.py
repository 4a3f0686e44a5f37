"""Hand-written CUDA kernels and their plain PyTorch versions.

Exports the counterparts of what ``motiondiffusion_moe_tpu/ops/__init__.py``
exports: the FAVOR+ core and the flash cross-attention, each with the plain
version it is held to.
"""

from motiondiffusion_moe_tpu_torch.ops.flash_attention import (  # noqa: F401
    flash_cross_attention,
    flash_cross_attention_plain,
)
from motiondiffusion_moe_tpu_torch.ops.performer import (  # noqa: F401
    favor_attention,
    favor_attention_plain,
)
