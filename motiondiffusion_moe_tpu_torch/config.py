"""The port's configuration: a copy of ``motiondiffusion_moe_tpu/config.py``.

Same frozen dataclasses, field names, defaults, presets (``small_dense``,
``moe_small``, ``moe_big``) and JSON form as the JAX package's, so a
``config.json`` written by either package loads in the other. The port
keeps its own copy so that it imports nothing of the JAX package. Fields
that only the JAX package acts on (the mesh axes of ``ParallelConfig``,
``scan_blocks``, ``remat_blocks``, ``TrainConfig.rng_impl``, ...) are kept
for the JSON round trip; the port raises or ignores them where its code
says so. ``TrainConfig.jax_rng_impl`` is dropped.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass(frozen=True)
class DataConfig:
    """Dataset constants (t2m / kit)."""

    dataset_name: str = "t2m"          # "t2m" (HumanML3D) or "kit"
    data_root: str = "./data/HumanML3D"
    dim_pose: int = 263                # 251 for kit
    num_joints: int = 22               # 21 for kit
    max_motion_length: int = 196       # fixed model sequence length
    min_motion_length: int = 40        # filter: 40 <= len < 200 (t2m); 24 for kit
    unit_length: int = 4               # temporal downsample unit (eval snapping)
    feat_bias: float = 25.0            # root-vel/foot-contact std divisor
    times: int = 1                     # dataset duplication multiplier
    max_text_len: int = 20             # GloVe token cap for the eval pathway
    use_native_io: bool = True         # C++ batch assembly (native/motionio.cc)

    @staticmethod
    def humanml3d(**kw: Any) -> "DataConfig":
        return DataConfig(dataset_name="t2m", dim_pose=263, num_joints=22,
                          min_motion_length=40, **kw)

    @staticmethod
    def kit(**kw: Any) -> "DataConfig":
        kw.setdefault("data_root", "./data/KIT-ML")
        return DataConfig(dataset_name="kit", dim_pose=251, num_joints=21,
                          min_motion_length=24, **kw)


@dataclass(frozen=True)
class DiffusionConfig:
    """Diffusion process: eps-prediction, FIXED_SMALL variance, MSE."""

    num_timesteps: int = 1000
    beta_schedule: str = "linear"      # linear | cosine | sqrt
    model_mean_type: str = "epsilon"   # epsilon | start_x | previous_x
    model_var_type: str = "fixed_small"  # fixed_small | fixed_large | learned | learned_range
    loss_type: str = "mse"             # mse | rescaled_mse | kl | rescaled_kl
    schedule_sampler: str = "uniform"  # uniform | loss-second-moment | adaptive
    cfg_scale: float = 7.5
    clip_denoised: bool = False


@dataclass(frozen=True)
class ModelConfig:
    """Denoiser and text-encoder architecture."""

    input_feats: int = 263
    max_frames: int = 196
    latent_dim: int = 512
    ff_size: int = 256                 # expert hidden size
    num_layers: int = 8                # per U-Net scale
    num_heads: int = 4
    dropout: float = 0.1
    activation: str = "gelu"
    # --- MoE ---
    use_moe: bool = True
    num_experts: int = 4
    moe_top_k: int = 2
    moe_capacity_factor: float = 2.0
    moe_aux_loss_weight: float = 0.01
    moe_num_branches: int = 2
    # "dense_fused" (every expert on every token, combine weights folded in),
    # "dense" (every expert on every token, then the combine) or "dispatch"
    # (each token to its top-k experts, up to moe_capacity_factor * S / E
    # slots per expert); fixed when the model is built
    moe_compute: str = "dense_fused"
    # --- attention ---
    # Performer FAVOR+ feature count (the reference's effective 128)
    num_random_features: int = 128
    xattn_chunk_size: int = 256
    # exact cross-attention through the fast-layout kernel
    # (ops/flash_attention.py::xattn_fastlayout) instead of the einsum path
    use_fast_xattn: bool = False
    # --- stochastic depth: survival probs linspace(1.0 -> min) ---
    stochastic_depth_min: float = 0.8
    # --- text encoder ---
    text_encoder: str = "hash"         # "deberta-v3-large" | "deberta-tiny" | "hash"
    text_encoder_ckpt: str = ""
    text_latent_dim: int = 128
    text_num_prompt_tokens: int = 8
    text_max_tokens: int = 77
    time_embed_mult: int = 4           # time_embed_dim = latent_dim * 4
    dtype: str = "bfloat16"            # compute dtype; params stay float32
    # JAX-only layouts and recompute policies (the port raises on them)
    remat_blocks: str = ""
    scan_blocks: bool = False
    pipeline_microbatches: int = 0


@dataclass(frozen=True)
class ParallelConfig:
    """Device-mesh layout (the port runs on one device so far)."""

    num_expert_partitions: int = 1
    num_model_partitions: int = 1
    num_seq_partitions: int = 1
    num_pipeline_stages: int = 1
    num_data_partitions: int = 0       # 0 = auto
    zero1: bool = False
    fsdp_axis: Optional[str] = None


@dataclass(frozen=True)
class TrainConfig:
    """Optimization."""

    batch_size: int = 32
    num_epochs: int = 50
    lr: float = 2e-4
    grad_clip_norm: float = 1.0
    seed: int = 0
    uncond_step: bool = True           # second unconditional step per batch
    caption_dropout: float = 0.0
    steps_per_call: int = 1
    grad_accum_steps: int = 1
    rng_impl: str = "rbg"              # JAX's PRNG; no effect in the port
    adam_mu_dtype: str = "float32"
    adam_nu_dtype: str = "float32"
    log_every: int = 50
    save_latest_every: int = 500
    save_every_epochs: int = 5
    ema_decay: float = 0.0
    lr_schedule: str = "constant"      # constant | cosine
    lr_warmup_steps: int = 0
    lr_decay_steps: int = 0
    w_velocity: float = 0.0
    w_acceleration: float = 0.0
    w_structure: float = 0.0
    w_progressive: float = 0.0


@dataclass(frozen=True)
class ExperimentConfig:
    name: str = "t2m_moe_small"
    checkpoint_dir: str = "./checkpoints"
    data: DataConfig = field(default_factory=DataConfig)
    diffusion: DiffusionConfig = field(default_factory=DiffusionConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    # ---------------- serialization round-trip ----------------
    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self, **kw: Any) -> str:
        return json.dumps(self.to_dict(), indent=2, **kw)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "ExperimentConfig":
        def build(cls, section):
            # unknown keys are dropped with a note, so a config.json from
            # another version (or the other package) still loads
            names = {f.name for f in dataclasses.fields(cls)}
            known = {k: v for k, v in section.items() if k in names}
            dropped = sorted(set(section) - names)
            if dropped:
                print(f"[config] note: ignoring unknown "
                      f"{cls.__name__} keys {dropped}")
            return cls(**known)

        return ExperimentConfig(
            name=d.get("name", "exp"),
            checkpoint_dir=d.get("checkpoint_dir", "./checkpoints"),
            data=build(DataConfig, d.get("data", {})),
            diffusion=build(DiffusionConfig, d.get("diffusion", {})),
            model=build(ModelConfig, d.get("model", {})),
            parallel=build(ParallelConfig, d.get("parallel", {})),
            train=build(TrainConfig, d.get("train", {})),
        )

    @staticmethod
    def from_json(s: str) -> "ExperimentConfig":
        return ExperimentConfig.from_dict(json.loads(s))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @staticmethod
    def load(path: str) -> "ExperimentConfig":
        with open(path) as f:
            return ExperimentConfig.from_json(f.read())

    # Convenience presets ------------------------------------------------
    @staticmethod
    def small_dense() -> "ExperimentConfig":
        """Dense (no-MoE) small transformer."""
        return ExperimentConfig(
            name="t2m_dense_small",
            model=ModelConfig(use_moe=False, num_layers=4, latent_dim=256,
                              ff_size=512, text_latent_dim=128),
        )

    @staticmethod
    def moe_small() -> "ExperimentConfig":
        """The flagship: the reference's live config."""
        return ExperimentConfig(name="t2m_moe_small")

    @staticmethod
    def moe_big() -> "ExperimentConfig":
        """The 'big' config: 16 experts, expert-sharded in the JAX
        package."""
        return ExperimentConfig(
            name="t2m_moe_big",
            model=ModelConfig(latent_dim=768, ff_size=1024, num_layers=12,
                              num_heads=8, num_experts=16),
            parallel=ParallelConfig(num_expert_partitions=8),
        )
