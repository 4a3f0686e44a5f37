"""Shared helpers of the ``test_torch_*`` parity tests.

The same numpy inputs (from a seed) go through the JAX package and the
PyTorch port; JAX stays on the CPU (tests/conftest.py). Flax parameters
reach the port through ``models/bridge.py``. Each package gets its own
config object: the JAX package the one these helpers build, the port
:func:`to_port` of it.
"""

import dataclasses

import jax
import numpy as np
import torch
from jax.experimental.pallas import tpu as pltpu

from motiondiffusion_moe_tpu.config import (
    DataConfig,
    DiffusionConfig,
    ExperimentConfig,
    ModelConfig,
)
from motiondiffusion_moe_tpu.ops import adaln_pallas
from motiondiffusion_moe_tpu_torch import config as port_config
from motiondiffusion_moe_tpu_torch.models.bridge import jax_to_state_dict
from tests._bf16 import assert_bf16_flips, bf16_flips  # noqa: F401

# one intra-op thread per worker: the suite runs under pytest-xdist
torch.set_num_threads(1)


def tiny_model_config(dtype: str = "float32", **kw) -> ModelConfig:
    base = dict(input_feats=26, max_frames=16, latent_dim=64, ff_size=32,
                num_layers=2, num_heads=2, num_experts=4, text_latent_dim=16,
                num_random_features=32, text_max_tokens=12, dropout=0.0,
                stochastic_depth_min=1.0, dtype=dtype)
    base.update(kw)
    return ModelConfig(**base)


def tiny_config(dtype: str = "float32", **kw) -> ExperimentConfig:
    return ExperimentConfig(
        name="tiny",
        data=DataConfig(dim_pose=26, max_motion_length=16,
                        min_motion_length=8, num_joints=4),
        # >= ~100 steps: the scaled-linear schedule degenerates at tiny T
        diffusion=DiffusionConfig(num_timesteps=100),
        model=tiny_model_config(dtype, **kw))


def to_port(cfg):
    """The port's config object equal to a JAX ``ExperimentConfig`` (through
    the JSON form both packages share) or ``ModelConfig``."""
    if isinstance(cfg, ModelConfig):
        return port_config.ModelConfig(**dataclasses.asdict(cfg))
    return port_config.ExperimentConfig.from_dict(cfg.to_dict())


def random_params(module, *args, seed: int = 0, **kwargs):
    """A flax ``params`` tree for ``module`` filled with seeded numpy draws
    (every leaf nonzero, kernels scaled by 1/sqrt(fan_in)). The tree's
    structure comes from ``jax.eval_shape`` of ``module.init``: no flax
    initialiser runs, which keeps the tests fast."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.key(0), *args, **kwargs))["params"]
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        n = rng.standard_normal(s.shape).astype(np.float32)
        if name == "scale" or name.endswith("norm_scale"):
            return 1.0 + 0.1 * n
        if name in ("kernel", "w1", "w2"):
            return n / np.sqrt(np.prod(s.shape[:-1]) if name == "kernel"
                               else s.shape[-2])
        if name == "fa_projection":
            return n * s.shape[0] ** -0.75
        return 0.1 * n

    return jax.tree_util.tree_map_with_path(fill, shapes)


def perturb_zero_leaves(params, seed: int = 0, scale: float = 0.05):
    """Add a seeded draw to every all-zero leaf (zero-init kernels, gates,
    biases) so that no module output is trivially zero or tied."""
    rng = np.random.default_rng(seed)

    def f(leaf):
        leaf = np.asarray(leaf, dtype=np.float32)
        if not leaf.any():
            leaf = leaf + scale * rng.standard_normal(leaf.shape).astype(
                np.float32)
        return leaf

    return jax.tree_util.tree_map(f, jax.device_get(params))


def load_into(module: torch.nn.Module, params) -> torch.nn.Module:
    """Load a flax ``params`` tree into a port module (strict) through the
    bridge; returns the module in eval mode."""
    module.load_state_dict(jax_to_state_dict(params), strict=True)
    return module.eval()


def adaln_as_the_tpu_kernel(*args):
    """The JAX package's adaln_dense as the TPU runs it: its Pallas kernel,
    in interpret mode (its CPU default is the reference, which rounds once
    more)."""
    with pltpu.force_tpu_interpret_mode():
        return adaln_pallas._adaln_pallas(*args)


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def rel_rms(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2) / np.mean(b ** 2)))


def assert_bf16_close(out: np.ndarray, ref: np.ndarray, ulps: int = 1) -> None:
    """Within ``ulps`` bf16 ulps of ``ref`` plus 2^-12 of max|ref|: both
    sides round the same f32 values, and a value whose f32 sums land on
    either side of a rounding boundary differs by one ulp."""
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -126)))
                  - 7)
    err = np.abs(out - ref)
    assert (err <= ulps * ulp + 2.0 ** -12 * np.abs(ref).max()).all(), (
        err.max())
