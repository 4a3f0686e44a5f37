"""Denoiser, text encoder and the flax -> torch weight bridge.

The JAX package's ``models`` exports, for every name that has a port
counterpart (the block stacking helpers of ``scan_blocks`` have none). The
DeBERTa encoder loads on first use, as in JAX.
"""

from motiondiffusion_moe_tpu_torch.models.embeddings import (  # noqa: F401
    TimestepEmbedding,
    GatedFusion,
    StylizationBlock,
    grad_clamp,
)
from motiondiffusion_moe_tpu_torch.models.attention import (  # noqa: F401
    FastAttention,
    PerformerSelfAttention,
    DualSelfAttentionBlock,
    LinearTemporalCrossAttention,
    GatedCrossAttention,
    CrossAttentionBlock,
)
from motiondiffusion_moe_tpu_torch.models.moe import (  # noqa: F401
    SwitchMoELayer,
    MoEMultiBranchFFN,
    DenseFFN,
)
from motiondiffusion_moe_tpu_torch.models.transformer import (  # noqa: F401
    MoEDecoderLayer,
    MotionTransformer,
)
from motiondiffusion_moe_tpu_torch.models.text_encoder import (  # noqa: F401
    HashTextEncoder,
    TextEncoding,
    get_text_encoder,
)
