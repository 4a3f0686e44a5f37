"""Evaluation CLI of the PyTorch port.

The counterpart of ``python -m motiondiffusion_moe_tpu.tools.evaluate``,
with the same flags plus ``--device``::

    python -m motiondiffusion_moe_tpu_torch.tools.evaluate \\
        --run_dir ./checkpoints/t2m_moe_small [--dataset synthetic] \\
        [--evaluator_ckpt path/to/finest.tar] [--glove_dir ./glove] \\
        [--replication_times 20] [--sampler dpm --steps 20]

``--run_dir`` is a run dir of either package's ``tools/train.py`` (the
port's steps or a JAX run's orbax ones), read through
``tools/export.py::load_run`` (``--use_ema`` as there) with the normalizer
from ``meta/``; ``--dataset real`` reads the ``--split`` of the run's
corpus (``config.json``'s ``data_root``). The model is placed on
``--device`` once (the card unless ``--device cpu``) and every prompt is
sampled through ``GenerationPipeline``; the evaluator networks embed on
the same device (``--device_embeddings`` embeds each micro-batch where it
was sampled and fetches only the co-embeddings); the metric math is numpy.
Without the released ``finest.tar`` the metrics come from a random-init
evaluator, and without the GloVe files from hashed word vectors: the
pipeline is exercised, but the values are not comparable to published
numbers, and the log says so.

Over several devices (``--data_parallel``, ``--expert_parallel``,
``--tensor_parallel``, the JAX CLI's mesh, ``tools/evaluate.py:155-173``
of the JAX package) the port runs one process per device, launched as
``tools/serve.py`` says; in one process a degree above 1 raises
``ValueError``. Each rank loads its shard of the run (in turns of as many
ranks as host memory holds); rank 0 runs
the protocol, its host RNG and the metrics and drives every generation on
all ranks as one job (``pipeline.MeshLeader``); the other ranks sample
with it until rank 0 stops them. ``--device_embeddings`` under a mesh
prints the JAX CLI's warning and takes the host path.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from motiondiffusion_moe_tpu_torch.parallel.mesh import add_launch_flags


def build_eval_samples(dataset, max_samples: int = 0) -> list:
    """EvalSamples (caption, tokens, normalised GT motion) from a
    ``Text2MotionDataset``: each item's first annotation, the motion cut
    to ``max_motion_length`` and zero-padded."""
    from motiondiffusion_moe_tpu_torch.eval import EvalSample

    samples = []
    names = (dataset.name_list[:max_samples] if max_samples
             else dataset.name_list)
    max_len = dataset.cfg.max_motion_length
    for name in names:
        entry = dataset.data_dict[name]
        ann = entry["text"][0]
        m_length = min(entry["length"], max_len)
        motion = entry["motion"][:m_length]
        padded = np.zeros((max_len, motion.shape[1]), np.float32)
        padded[:m_length] = dataset.normalizer.normalize_np(motion)
        samples.append(EvalSample(caption=ann.caption, tokens=list(ann.tokens),
                                  motion=padded, m_length=int(m_length)))
    return samples


def build_synthetic_eval_samples(cfg, n: int = 64, seed: int = 0) -> list:
    from motiondiffusion_moe_tpu_torch.data.dataset import (
        SyntheticText2MotionDataset)
    from motiondiffusion_moe_tpu_torch.eval import EvalSample

    ds = SyntheticText2MotionDataset(cfg.data, size=n, seed=seed)
    samples = []
    for i in range(n):
        caption, motion, m_length = ds[i]
        tokens = [f"{w}/OTHER" for w in caption.split()]
        samples.append(EvalSample(caption=caption, tokens=tokens,
                                  motion=motion, m_length=m_length))
    return samples


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Evaluate a trained run (the Guo et al. protocol)")
    p.add_argument("--run_dir", required=True,
                   help="the port's training run dir (config.json, ckpt/, "
                        "meta/)")
    p.add_argument("--device", default="cuda",
                   help="torch device to sample and embed on (default cuda; "
                        "raises when it is not available, never moves to "
                        "the CPU on its own)")
    p.add_argument("--dataset", default="real", choices=["real", "synthetic"])
    p.add_argument("--split", default="test")
    p.add_argument("--evaluator_ckpt", default="",
                   help="path to released finest.tar (FID backbone weights)")
    p.add_argument("--glove_dir", default="./glove")
    p.add_argument("--log_file", default="")
    p.add_argument("--sampler", default="ddpm",
                   choices=["ddpm", "ddim", "dpm"])
    p.add_argument("--use_ema", action="store_true",
                   help="sample with the EMA weights (run must be trained "
                        "with --ema_decay > 0)")
    p.add_argument("--steps", type=int, default=0)
    p.add_argument("--batch_size", type=int, default=32,
                   help="generation micro-batch (serving shape)")
    p.add_argument("--protocol_batch_size", type=int, default=512,
                   help="retrieval-pool size for R-precision/Matching "
                        "Score (the reference protocol uses 512)")
    p.add_argument("--replication_times", type=int, default=20)
    p.add_argument("--mm_num_samples", type=int, default=100)
    p.add_argument("--mm_num_repeats", type=int, default=30)
    p.add_argument("--mm_num_times", type=int, default=10)
    p.add_argument("--diversity_times", type=int, default=300)
    p.add_argument("--max_samples", type=int, default=0,
                   help="cap the eval set size (0 = all)")
    p.add_argument("--score_samples", type=int, default=0,
                   help="cap the joint-space MAE/velocity/jerk scoring set "
                        "(0 = the FULL eval set, matching the reference's "
                        "whole-test-loader score loop)")
    p.add_argument("--skip_joint_scores", action="store_true")
    p.add_argument("--device_embeddings", action="store_true",
                   help="embed each generated micro-batch with the "
                        "evaluator's motion encoder on the device and fetch "
                        "512-d rows instead of raw motions")
    add_launch_flags(p)
    return p


def main(argv=None) -> dict:
    """Run the protocol; returns {"summary", "per_replication", "joint"
    ((MAE [n], velocity error, jerk error) or None), "log_file"} (None on
    a rank other than 0 of a mesh, once rank 0 stops it)."""
    import torch.distributed as dist

    args = build_argparser().parse_args(argv)
    try:
        return _main(args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _main(args):
    from motiondiffusion_moe_tpu_torch.parallel.distributed import in_turn
    from motiondiffusion_moe_tpu_torch.parallel.mesh import (
        launch_generation)
    from motiondiffusion_moe_tpu_torch.pipeline import (
        GenerationPipeline, MeshLeader)
    from motiondiffusion_moe_tpu_torch.tools.export import (
        artifact_bytes, load_run)

    mesh, device = launch_generation(args)

    def load():
        cfg, params, step, normalizer = load_run(
            args.run_dir, use_ema=args.use_ema, mesh=mesh)
        pipe = GenerationPipeline(cfg, params=params, sampler=args.sampler,
                                  num_inference_steps=args.steps or None,
                                  micro_batch=args.batch_size, device=device,
                                  mesh=mesh)
        return cfg, pipe, step, normalizer

    cfg, pipe, step, normalizer = (
        load() if mesh is None else in_turn(load,
                                            artifact_bytes(args.run_dir)))
    print(f"[evaluate] restored step {step} (ema={args.use_ema}) on "
          f"{device}" + (f", rank {mesh.rank} of data {mesh.dp} x expert "
                         f"{mesh.ep} x model {mesh.tp}" if mesh else ""))
    if mesh is not None and mesh.rank:
        n = pipe.follow_jobs()
        print(f"[evaluate] rank {mesh.rank}: {n} generations, stopped by "
              "rank 0")
        return None
    if mesh is None:
        return _evaluate(args, cfg, pipe, normalizer, device)
    leader = MeshLeader(pipe)
    try:
        return _evaluate(args, cfg, leader, normalizer, device)
    finally:
        leader.stop()


def _evaluate(args, cfg, pipe, normalizer, device):
    """The protocol on rank 0 (or the one process) with ``pipe`` (a
    pipeline or a ``MeshLeader``)."""
    import torch

    from motiondiffusion_moe_tpu_torch.data.dataset import (
        Text2MotionDataset)
    from motiondiffusion_moe_tpu_torch.data.normalizer import (
        MotionNormalizer)
    from motiondiffusion_moe_tpu_torch.eval import (
        EvaluatorModelWrapper, ProtocolConfig, evaluation,
        get_word_vectorizer, score_mae_velocity_jerk)
    from motiondiffusion_moe_tpu_torch.eval.word_vectorizer import (
        HashedWordVectorizer)
    from motiondiffusion_moe_tpu_torch.motion.recover import recover_from_ric
    from motiondiffusion_moe_tpu_torch.pipeline import MeshLeader

    if normalizer is None:
        normalizer = MotionNormalizer.identity(cfg.data.dim_pose)

    if args.dataset == "synthetic":
        samples = build_synthetic_eval_samples(cfg, n=args.max_samples or 64)
    else:
        # the eval set needs the parsed items only, not the native store's
        # batch assembly
        ds = Text2MotionDataset(cfg.data, split=args.split,
                                normalizer=normalizer, use_native=False)
        samples = build_eval_samples(ds, args.max_samples)
    print(f"[evaluate] {len(samples)} eval samples")

    def seeded(seed: int) -> torch.Generator:
        return torch.Generator(device).manual_seed(seed)

    def generate(captions, lens, seed):
        return pipe.generate(captions, lens, generator=seeded(seed))

    if args.evaluator_ckpt:
        wrapper = EvaluatorModelWrapper.from_torch_checkpoint(
            args.evaluator_ckpt, dim_pose=cfg.data.dim_pose,
            unit_length=cfg.data.unit_length, device=device)
        print("[evaluate] loaded evaluator weights from "
              f"{args.evaluator_ckpt}")
    else:
        wrapper = EvaluatorModelWrapper(dim_pose=cfg.data.dim_pose,
                                        unit_length=cfg.data.unit_length,
                                        device=device)
        print("[evaluate] WARNING: random-init evaluator (no finest.tar) — "
              "metric VALUES are not comparable to published numbers")

    wv = get_word_vectorizer(args.glove_dir)
    if isinstance(wv, HashedWordVectorizer):
        print("[evaluate] WARNING: GloVe files not found — hashed word "
              "vectors in use")

    log_file = args.log_file or os.path.join(args.run_dir, "evaluation.log")
    pcfg = ProtocolConfig(
        mm_num_samples=args.mm_num_samples,
        mm_num_repeats=args.mm_num_repeats,
        mm_num_times=args.mm_num_times,
        diversity_times=args.diversity_times,
        replication_times=args.replication_times,
        batch_size=args.protocol_batch_size,
        unit_length=cfg.data.unit_length,
        max_motion_length=cfg.data.max_motion_length,
        max_text_len=cfg.data.max_text_len)
    embed_generate = None
    if args.device_embeddings and isinstance(pipe, MeshLeader):
        print("[evaluate] WARNING: --device_embeddings unsupported under a "
              "mesh; using the host path")
    elif args.device_embeddings:
        def embed_generate(captions, lens, seed):
            return pipe.generate_motion_embeddings(
                captions, lens, wrapper, generator=seeded(seed))
    per_replication: dict = {}
    summary = evaluation(samples, generate, wrapper, wv, log_file, pcfg,
                         model_name=cfg.name, embed_generate=embed_generate,
                         per_replication=per_replication)

    joint = None
    if not args.skip_joint_scores:
        # MAE / velocity / jerk in joint space over the whole eval set by
        # default, as the reference's score loop; --score_samples cuts it
        n = (min(len(samples), args.score_samples) if args.score_samples
             else len(samples))
        print(f"[evaluate] joint-space scores over {n}/{len(samples)} "
              "samples")
        outs = generate([s.caption for s in samples[:n]],
                        [s.m_length for s in samples[:n]], 12345)
        T, D = cfg.data.max_motion_length, cfg.data.dim_pose
        pred = np.zeros((n, T, D), np.float32)
        orig = np.zeros((n, T, D), np.float32)
        for i, (o, s) in enumerate(zip(outs, samples[:n])):
            pred[i, :o.shape[0]] = o[:T]
            orig[i] = s.motion

        def joints(features: np.ndarray) -> np.ndarray:
            x = torch.from_numpy(normalizer.denormalize_np(features))
            return recover_from_ric(x.to(device), cfg.data.num_joints
                                    ).cpu().numpy()

        mae, vel, jerk, _ = score_mae_velocity_jerk(joints(pred),
                                                    joints(orig))
        joint = (mae, vel, jerk)
        print(f"[evaluate] MAE={mae.mean():.4f} velocity_err={vel:.4f} "
              f"jerk_err={jerk:.4f}")

    print(f"[evaluate] log -> {log_file}")
    return {"summary": summary, "per_replication": per_replication,
            "joint": joint, "log_file": log_file}


if __name__ == "__main__":
    main()
