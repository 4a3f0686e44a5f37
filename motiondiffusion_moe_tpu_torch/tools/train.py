"""Training CLI of the PyTorch port.

The counterpart of ``python -m motiondiffusion_moe_tpu.tools.train``, with
the same flags plus ``--device``::

    python -m motiondiffusion_moe_tpu_torch.tools.train --dataset t2m \\
        --data_root data/HumanML3D --device cuda

``--dataset t2m`` / ``kit`` read a HumanML3D / KIT-ML directory
(``new_joint_vecs/``, ``texts/``, ``train.txt``; ``tools/prepare_data.py``
makes one from raw joints) through ``Text2MotionDataset``, its batches
assembled by the native C++ store unless ``--no_native_io``;
``--dataset synthetic`` takes no files. The config is written to
``<checkpoint_dir>/<name>/config.json`` (the JAX package's format) and the
normalizer to ``meta/``; checkpoints go to ``ckpt/`` and a rerun resumes
from the newest. A run dir of the JAX package's ``tools/train.py`` (orbax
steps in ``ckpt/``) resumes the same way, given the flags it was trained
with: its parameters, Adam moments and count, EMA, step and epoch, and the
run goes on saving in the JAX layout, which the JAX package resumes again
(``training/checkpoint.py``). ``--text_encoder deberta-v3-large`` (or
``deberta-tiny``) trains the DeBERTa text encoder jointly, from the local
HF checkpoint ``--deberta_ckpt`` when given (grafted at init) and else
from its random init, with a warning.

Data-, seq-, pipeline-, expert- and tensor-parallel training runs one
process per device, launched by torchrun::

    torchrun --nproc_per_node N -m motiondiffusion_moe_tpu_torch.tools.train \
        [--seq_parallel SP] [--expert_parallel EP] [--tensor_parallel TP] \
        [--data_parallel N/(SP EP TP)] [--zero1] ...
    torchrun --nproc_per_node N -m motiondiffusion_moe_tpu_torch.tools.train \
        --pipeline_parallel PP [--pp_microbatches M] [--zero1] ...

or by starting each process with the JAX CLI's three flags,
``--coordinator_address HOST:PORT --num_processes N --process_id R`` (an
init URL such as ``file:///shared/rendezvous`` also serves as the
address). The N processes form JAX's ``(data, seq, expert, model)`` mesh,
rank ``R = ((d * SP + s) * EP + e) * TP + m``: rank R trains on frames
``ExpertMesh.frames(T, s)`` of its rows (the Performers' kv and its
gradient closed over the seq ranks, kernel 3 in three launches), keeps
experts ``[e E / EP, (e + 1) E /
EP)`` of every MoE layer (``--num_experts`` divisible by EP) and its
``1 / TP`` of JAX's Megatron split of the FFN pairs (the experts' hidden
width, the dense FFN branches, the cross-attention MLP); attention, norms,
embeddings and the gate stay whole on every rank; ``dense_fused`` runs as
``dense`` under EP or TP, and ``--data_parallel`` 0 means N / (SP EP TP).
The TP ranks of a model group and the SP ranks of a seq group hold the
same rows: row-holder ``q = d * EP + e`` takes rows ``[q B / Q, (q + 1) B /
Q)`` of every ``--batch_size`` batch through ``DistributedSampler``, ``Q =
N / (SP TP)`` (Q must divide each microbatch, and the data's
``max_motion_length`` be at least 2 SP). Each process takes
``cuda:LOCAL_RANK`` unless ``--device`` names a card; ``--zero1`` shards
the Adam moments and the EMA over the processes that reduce each
gradient. The backend follows the device: NCCL
for CUDA, gloo for the CPU. Only the primary writes ``config.json``,
``meta/`` and the checkpoints (in the global layout) and prints.

``--pipeline_parallel PP`` (with ``--data_parallel`` alone beside it, as in
JAX) makes the N processes a ``(data, pipe)`` mesh, rank ``R = d * PP +
p``: rank R keeps blocks ``[p L / PP, (p + 1) L / PP)`` of each scale
(``--num_layers`` divisible by PP) and runs them as a GPipe ring of
``--pp_microbatches`` microbatches (0: 2 PP; each data rank's rows of a
microbatch must divide into them); the PP ranks of a pipe group hold the
same rows, ``Q = N / PP``. JAX needs ``--scan_blocks`` for it; the port
has no stacked layout and needs none: ``--scan_blocks`` and
``--remat_blocks``, which exist for JAX compilation, raise. A pipeline
run's saves hold the named layout, which any layout of the port resumes
and the JAX package's named-layout runs restore.
"""

from __future__ import annotations

import argparse
import os


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Train the MoE motion diffusion model (PyTorch port)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda; raises when "
                        "it is not available, never moves to the CPU on its "
                        "own)")
    p.add_argument("--name", default="t2m_moe_small")
    p.add_argument("--dataset", default="t2m",
                   choices=["t2m", "kit", "synthetic"],
                   help="t2m / kit: a HumanML3D / KIT-ML directory under "
                        "--data_root; synthetic: generated, no files")
    p.add_argument("--data_root", default="./data/HumanML3D")
    p.add_argument("--checkpoint_dir", default="./checkpoints")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--num_epochs", type=int, default=50)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--diffusion_steps", type=int, default=1000)
    p.add_argument("--beta_schedule", default="linear",
                   choices=["linear", "cosine", "sqrt"])
    p.add_argument("--schedule_sampler", default="uniform",
                   choices=["uniform", "loss-second-moment", "adaptive-loss"])
    p.add_argument("--num_layers", type=int, default=8)
    p.add_argument("--latent_dim", type=int, default=512)
    p.add_argument("--ff_size", type=int, default=256)
    p.add_argument("--num_heads", type=int, default=4)
    p.add_argument("--num_experts", type=int, default=4)
    p.add_argument("--no_moe", action="store_true")
    p.add_argument("--model_size", default="small", choices=["small", "big"])
    p.add_argument("--text_encoder", default="hash",
                   choices=["hash", "deberta-v3-large", "deberta-tiny"])
    p.add_argument("--deberta_ckpt", default="",
                   help="local HF DeBERTa checkpoint (dir with "
                        "pytorch_model.bin, or a .bin/.pt file) grafted "
                        "into the text encoder at init; without it a "
                        "deberta text_encoder trains from RANDOM init "
                        "(warned)")
    p.add_argument("--text_latent_dim", type=int, default=128)
    p.add_argument("--times", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--save_latest", type=int, default=500)
    p.add_argument("--save_every_e", type=int, default=5)
    p.add_argument("--no_uncond_step", action="store_true")
    p.add_argument("--steps_per_call", type=int, default=1,
                   help="optimizer steps per compiled call in the JAX "
                        "package; the port runs every step as its own call, "
                        "with the same semantics")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="gradient-accumulation microbatches per optimizer "
                        "update (batch_size must divide evenly)")
    p.add_argument("--rng_impl", default="rbg", choices=["rbg", "threefry"],
                   help="accepted for the JAX CLI's sake and has NO effect "
                        "here: every draw comes from one torch.Generator")
    p.add_argument("--adam_mu_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="Adam first-moment storage dtype")
    p.add_argument("--adam_nu_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="Adam second-moment storage dtype")
    p.add_argument("--remat_blocks", default="",
                   choices=["", "dots", "dots_named", "all"],
                   help="JAX rematerialisation policy: not ported, raises "
                        "unless empty")
    p.add_argument("--scan_blocks", action="store_true",
                   help="JAX stacked-block layout: not ported, raises "
                        "(--pipeline_parallel needs no --scan_blocks here)")
    p.add_argument("--ema_decay", type=float, default=0.0,
                   help="weight-EMA decay (0 = off; e.g. 0.9999)")
    p.add_argument("--lr_schedule", default="constant",
                   choices=["constant", "cosine"])
    p.add_argument("--lr_warmup_steps", type=int, default=0,
                   help="linear 0 -> lr warmup steps")
    p.add_argument("--lr_decay_steps", type=int, default=0,
                   help="total steps for the cosine decay (incl. warmup)")
    p.add_argument("--caption_dropout", type=float, default=0.0)
    p.add_argument("--w_velocity", type=float, default=0.0)
    p.add_argument("--w_acceleration", type=float, default=0.0)
    p.add_argument("--w_structure", type=float, default=0.0)
    p.add_argument("--w_progressive", type=float, default=0.0)
    p.add_argument("--expert_parallel", type=int, default=1,
                   help="expert partitions: each process keeps E / N of "
                        "every MoE layer's experts (the processes launched "
                        "must be a multiple)")
    p.add_argument("--tensor_parallel", type=int, default=1,
                   help="model partitions: JAX's Megatron split of the FFN "
                        "pairs, each process keeping 1 / N of their hidden "
                        "width; the ranks of a model group share their rows")
    p.add_argument("--seq_parallel", type=int, default=1,
                   help="seq partitions: each process trains on its 1 / N of "
                        "every motion's frames; the ranks of a seq group "
                        "share their rows")
    p.add_argument("--pipeline_parallel", type=int, default=1,
                   help="pipeline stages: each process keeps num_layers / N "
                        "contiguous blocks of each scale and runs them as a "
                        "GPipe ring; the ranks of a pipe group share their "
                        "rows (composes with --data_parallel alone)")
    p.add_argument("--data_parallel", type=int, default=0,
                   help="data-parallel ranks, one process each (0 = the "
                        "number of processes launched over --seq_parallel "
                        "x --pipeline_parallel x --expert_parallel x "
                        "--tensor_parallel)")
    p.add_argument("--pp_microbatches", type=int, default=0,
                   help="microbatches of the pipeline ring (0 = 2 x "
                        "--pipeline_parallel; read only with "
                        "--pipeline_parallel)")
    p.add_argument("--zero1", action="store_true",
                   help="shard the Adam moments and the EMA over the ranks "
                        "that reduce each gradient (ZeRO-1)")
    p.add_argument("--synthetic_size", type=int, default=256,
                   help="synthetic dataset size (dataset=synthetic)")
    p.add_argument("--no_native_io", action="store_true",
                   help="assemble batches in Python instead of the native "
                        "C++ store (which otherwise must build, or the run "
                        "raises)")
    p.add_argument("--coordinator_address", default="",
                   help="multi-process: HOST:PORT of rank 0 (or an init URL, "
                        "e.g. file:///shared/rendezvous)")
    p.add_argument("--num_processes", type=int, default=0,
                   help="multi-process: the number of processes")
    p.add_argument("--process_id", type=int, default=-1,
                   help="multi-process: this process's rank")
    return p


def check_supported(args: argparse.Namespace) -> None:
    """Raise for what the port does not run yet (see the module doc)."""
    if args.scan_blocks or args.remat_blocks:
        raise NotImplementedError(
            "--scan_blocks / --remat_blocks exist for JAX compilation and "
            "are not ported; the port's --pipeline_parallel needs no "
            "--scan_blocks (each rank keeps its stage's named blocks, and "
            "saves the named layout, which a JAX --scan_blocks run does not "
            "restore)")


def config_from_args(args: argparse.Namespace):
    """The JAX CLI's ``config_from_args`` (same flags, same config)."""
    from motiondiffusion_moe_tpu_torch.config import (
        DataConfig, DiffusionConfig, ExperimentConfig, ModelConfig,
        ParallelConfig, TrainConfig)

    if args.dataset == "kit":
        data = DataConfig.kit(data_root=args.data_root, times=args.times,
                              use_native_io=not args.no_native_io)
    else:
        data = DataConfig.humanml3d(data_root=args.data_root,
                                    times=args.times,
                                    use_native_io=not args.no_native_io)
    mult = 2 if args.model_size == "big" else 1
    model = ModelConfig(
        input_feats=data.dim_pose, max_frames=data.max_motion_length,
        latent_dim=args.latent_dim * mult, ff_size=args.ff_size * mult,
        num_layers=args.num_layers, num_heads=args.num_heads,
        use_moe=not args.no_moe, num_experts=args.num_experts,
        text_encoder=args.text_encoder, text_encoder_ckpt=args.deberta_ckpt,
        text_latent_dim=args.text_latent_dim * mult,
        remat_blocks=args.remat_blocks, scan_blocks=args.scan_blocks,
        pipeline_microbatches=args.pp_microbatches)
    return ExperimentConfig(
        name=args.name,
        checkpoint_dir=args.checkpoint_dir,
        data=data,
        diffusion=DiffusionConfig(num_timesteps=args.diffusion_steps,
                                  beta_schedule=args.beta_schedule,
                                  schedule_sampler=args.schedule_sampler),
        model=model,
        parallel=ParallelConfig(num_expert_partitions=args.expert_parallel,
                                num_model_partitions=args.tensor_parallel,
                                num_data_partitions=args.data_parallel,
                                num_seq_partitions=args.seq_parallel,
                                num_pipeline_stages=args.pipeline_parallel,
                                zero1=args.zero1),
        train=TrainConfig(batch_size=args.batch_size,
                          num_epochs=args.num_epochs, lr=args.lr,
                          seed=args.seed,
                          steps_per_call=args.steps_per_call,
                          grad_accum_steps=args.grad_accum,
                          rng_impl=args.rng_impl,
                          adam_mu_dtype=args.adam_mu_dtype,
                          adam_nu_dtype=args.adam_nu_dtype,
                          uncond_step=not args.no_uncond_step,
                          caption_dropout=args.caption_dropout,
                          ema_decay=args.ema_decay,
                          lr_schedule=args.lr_schedule,
                          lr_warmup_steps=args.lr_warmup_steps,
                          lr_decay_steps=args.lr_decay_steps,
                          log_every=args.log_every,
                          save_latest_every=args.save_latest,
                          save_every_epochs=args.save_every_e,
                          w_velocity=args.w_velocity,
                          w_acceleration=args.w_acceleration,
                          w_structure=args.w_structure,
                          w_progressive=args.w_progressive))


def main(argv=None):
    """Train; returns the final :class:`TrainState`."""
    args = build_argparser().parse_args(argv)
    check_supported(args)
    cfg = config_from_args(args)

    import torch
    import torch.distributed as dist

    from motiondiffusion_moe_tpu_torch.data.dataset import (
        SyntheticText2MotionDataset, Text2MotionDataset)
    from motiondiffusion_moe_tpu_torch.data.loader import (
        DataLoader, DistributedSampler)
    from motiondiffusion_moe_tpu_torch.parallel.distributed import (
        initialize_distributed, is_primary, rank_device, world_size)
    from motiondiffusion_moe_tpu_torch.parallel.mesh import check_mesh
    from motiondiffusion_moe_tpu_torch.training.checkpoint import (
        CheckpointManager)
    from motiondiffusion_moe_tpu_torch.training.trainer import Trainer

    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        raise RuntimeError(f"--device {args.device}: no CUDA device is "
                           "available (pass --device cpu to train on the "
                           "CPU)")
    # the process group first: NCCL binds to the card set before it
    own_group = initialize_distributed(
        coordinator_address=args.coordinator_address or None,
        num_processes=args.num_processes or None,
        process_id=args.process_id if args.process_id >= 0 else None,
        device=args.device)
    try:
        check_mesh(cfg)  # before anything is written
        device = rank_device(args.device)
        primary = is_primary()
        run_dir = os.path.join(cfg.checkpoint_dir, cfg.name)
        os.makedirs(run_dir, exist_ok=True)
        if primary:
            cfg.save(os.path.join(run_dir, "config.json"))
            print(f"[train] config -> {run_dir}/config.json")
            print(f"[train] device: {device}"
                  + (f" ({torch.cuda.get_device_name(device)})"
                     if device.type == "cuda" else "")
                  + (f"; {world_size()} processes over "
                     f"{dist.get_backend()}" if world_size() > 1 else ""))

        if args.dataset == "synthetic":
            dataset = SyntheticText2MotionDataset(
                cfg.data, size=args.synthetic_size, seed=cfg.train.seed)
        else:
            dataset = Text2MotionDataset(cfg.data, split="train",
                                         seed=cfg.train.seed)
        if primary:
            dataset.normalizer.save(os.path.join(run_dir, "meta"))
        norm = dataset.normalizer
        trainer = Trainer(cfg, normalizer_stats=(norm.mean, norm.std),
                          device=device)
        # each row-holder its own rows of every global batch (the ranks of
        # a model group the same rows; check_mesh: Q divides the batch)
        sampler = DistributedSampler(len(dataset),
                                     num_replicas=trainer.holders,
                                     rank=trainer.q, seed=cfg.train.seed)
        loader = DataLoader(dataset,
                            batch_size=cfg.train.batch_size // trainer.holders,
                            sampler=sampler, seed=cfg.train.seed)
        state = trainer.init_state()
        ckpt = CheckpointManager(os.path.join(run_dir, "ckpt"), cfg=cfg)
        state = trainer.fit(state, loader, checkpoints=ckpt)
        if primary:
            print("[train] done")
        return state
    finally:
        if own_group:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
