"""Write the committed JAX run fixture ``tests/fixtures/jax_orbax_run/``.

A run dir as the JAX package's ``tools/train.py`` leaves it (``config.json``,
``meta/``, ``ckpt/`` with one orbax step in OCDBT with zstd chunks, and the
``epoch_meta.json`` sidecar), written by the JAX package's own ``Trainer``
and ``CheckpointManager``: 2 train steps of a 1-layer denoiser at latent 8
with an EMA, a warmup learning-rate schedule (so ``opt_state.1.1`` exists),
bf16 Adam ``mu`` and the training key saved (``has_rng``). The hash text
encoder's embedding is cut from [8192, 256] to [64, 16], and its tokenizer
to 64 buckets (a subclass with other defaults and a partial, set in for
this script only), so that the run stays under 1 MiB: the fixture is read,
never run. Every other width is the config's.

Beside it, ``tests/fixtures/jax_orbax_run.npz`` holds every leaf of the
step as the JAX ``CheckpointManager.restore_with_rng`` gives it, keyed by
its dotted orbax name (``opt_state.1.0.mu.params.out.kernel``); bf16 leaves
are stored as their uint16 words and listed in ``__bf16__``. The port's
reader is held to these leaves on the CPU (``tests/test_torch_orbax.py``)
and on the card, where no JAX exists (``chip_smoke.py`` phase L1).

Usage:  JAX_PLATFORMS=cpu python -m tests.make_orbax_fixture
"""

import os
import shutil
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

FIXTURES = os.path.join(REPO, "tests", "fixtures")
RUN = os.path.join(FIXTURES, "jax_orbax_run")
NPZ = os.path.join(FIXTURES, "jax_orbax_run.npz")
VOCAB, HIDDEN = 64, 16


def small_text_encoder():
    """Patch the JAX hash text encoder to a [VOCAB, HIDDEN] embedding, and
    its tokenizer to VOCAB buckets (an id past the table reads NaN)."""
    import functools

    from motiondiffusion_moe_tpu.models import text_encoder as te

    class SmallHashTextEncoder(te.HashTextEncoder):
        hidden_size: int = HIDDEN
        vocab_size: int = VOCAB

    te.HashTextEncoder = SmallHashTextEncoder
    te.hash_tokenize = functools.partial(te.hash_tokenize, vocab_size=VOCAB)


def fixture_config():
    from motiondiffusion_moe_tpu.config import (
        DataConfig, DiffusionConfig, ExperimentConfig, ModelConfig,
        TrainConfig)

    F = 26
    return ExperimentConfig(
        name="jax_orbax_run", checkpoint_dir=FIXTURES,
        data=DataConfig(dim_pose=F, max_motion_length=16,
                        min_motion_length=8, num_joints=4),
        diffusion=DiffusionConfig(num_timesteps=100),
        model=ModelConfig(input_feats=F, max_frames=16, latent_dim=8,
                          ff_size=8, num_layers=1, num_heads=2,
                          num_experts=2, text_latent_dim=8,
                          num_random_features=8, text_max_tokens=8,
                          dropout=0.0, stochastic_depth_min=1.0,
                          dtype="float32"),
        train=TrainConfig(batch_size=4, num_epochs=1, uncond_step=False,
                          ema_decay=0.9, lr_warmup_steps=10,
                          adam_mu_dtype="bfloat16", save_latest_every=2,
                          seed=3))


def dotted(path) -> str:
    """A JAX key path as orbax names its array."""
    parts = []
    for k in path:
        for attr in ("key", "idx", "name"):
            if hasattr(k, attr):
                parts.append(str(getattr(k, attr)))
                break
    return ".".join(parts)


def restored_leaves(state, epoch, rng) -> dict:
    """{dotted name: numpy leaf} of what ``restore_with_rng`` gave, in the
    checkpoint's own tree (bf16 as uint16 words under ``__bf16__``)."""
    tree = {"params": state.params, "opt_state": state.opt_state,
            "ema_params": state.ema_params, "step": state.step,
            "epoch": np.asarray(epoch, np.int64)}
    key = np.asarray(jax.random.key_data(rng)).ravel()
    rng_words = np.zeros(4, np.uint32)
    rng_words[:key.size] = key
    tree.update(rng=rng_words, rng_width=np.asarray(key.size, np.int64),
                has_rng=np.asarray(True))
    out, bf16 = {}, []
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        name, leaf = dotted(path), np.asarray(leaf)
        if leaf.dtype.name == "bfloat16":
            bf16.append(name)
            leaf = leaf.view(np.uint16)
        out[name] = leaf
    out["__bf16__"] = np.asarray(sorted(bf16))
    return out


def main() -> None:
    small_text_encoder()
    from motiondiffusion_moe_tpu.data import (
        DataLoader, DistributedSampler, MotionNormalizer,
        SyntheticText2MotionDataset)
    from motiondiffusion_moe_tpu.training import CheckpointManager, Trainer

    cfg = fixture_config()
    shutil.rmtree(RUN, ignore_errors=True)
    os.makedirs(RUN)
    cfg.save(os.path.join(RUN, "config.json"))
    dataset = SyntheticText2MotionDataset(cfg.data, size=8,
                                          seed=cfg.train.seed)
    F = cfg.data.dim_pose
    MotionNormalizer(np.linspace(-0.5, 0.5, F).astype(np.float32),
                     np.linspace(0.5, 2.0, F).astype(np.float32)).save(
        os.path.join(RUN, "meta"))
    loader = DataLoader(dataset, batch_size=cfg.train.batch_size,
                        sampler=DistributedSampler(len(dataset),
                                                   seed=cfg.train.seed),
                        seed=cfg.train.seed)
    trainer = Trainer(cfg)
    ckpt = CheckpointManager(os.path.join(RUN, "ckpt"))
    trainer.fit(trainer.init_state(), loader, checkpoints=ckpt)
    ckpt.close()

    reader = CheckpointManager(os.path.join(RUN, "ckpt"))
    step = reader.latest_step()
    state, epoch, rng = reader.restore_with_rng(trainer.init_state(), step)
    leaves = restored_leaves(state, epoch, rng)
    # restore_with_rng applies the epoch sidecar; the .npz keeps the epoch
    # the step stores
    import orbax.checkpoint as ocp
    stored = int(ocp.PyTreeCheckpointer().restore(
        os.path.join(RUN, "ckpt", str(step), "default"))["epoch"])
    leaves["epoch"] = np.asarray(stored, np.int64)
    meta = reader._read_epoch_meta()
    np.savez_compressed(NPZ, **leaves)
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(RUN) for f in fs)
    print(f"[fixture] step {step}, epoch {stored} (sidecar: {meta}), "
          f"{len(leaves) - 1} leaves; run {size} bytes, npz "
          f"{os.path.getsize(NPZ)} bytes -> {RUN}")


if __name__ == "__main__":
    main()
