"""Training: loss terms, the optimizer and train step, checkpoints, the
trainer.

The JAX package's ``training`` exports, for every name that has a port
counterpart: ``select_params`` has none (the ``--use_ema`` choice lives in
``tools/export.py::load_run``), nor ``make_train_step`` (the port's train
step is the class ``train_state.TrainStep``).
"""

from motiondiffusion_moe_tpu_torch.training.losses import (  # noqa: F401
    masked_frame_mse,
    velocity_loss,
    acceleration_loss,
    structure_loss,
    progressive_loss,
)
from motiondiffusion_moe_tpu_torch.training.train_state import (  # noqa: F401
    TrainState,
    create_train_state,
)
from motiondiffusion_moe_tpu_torch.training.trainer import Trainer  # noqa: F401
from motiondiffusion_moe_tpu_torch.training.checkpoint import (  # noqa: F401
    CheckpointManager,
)
