"""Host-side utilities.

The JAX package's ``utils`` exports, for every name that has a port
counterpart (``enable_compilation_cache``, XLA's compilation cache, has
none). ``plot`` and ``bench_init`` load on first use, as in JAX.
"""

from motiondiffusion_moe_tpu_torch.utils.logging import (  # noqa: F401
    MetricsLogger,
    print_current_loss,
)
from motiondiffusion_moe_tpu_torch.utils.profiling import (  # noqa: F401
    StepTimer,
    annotate,
    trace,
)
from motiondiffusion_moe_tpu_torch.utils.debugging import (  # noqa: F401
    assert_finite_tree,
    check_finite,
    checked,
    enable_nan_debugging,
)
from motiondiffusion_moe_tpu_torch.utils.media import (  # noqa: F401
    compose_gif_img_list,
    compose_image,
    compose_and_save_img,
    save_images,
    list_cut_average,
)
