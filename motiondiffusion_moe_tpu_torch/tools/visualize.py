"""Visualization CLI: text -> GIF of generated motion.

Port of ``motiondiffusion_moe_tpu/tools/visualize.py``, the JAX CLI's flags
plus ``--device``::

    python -m motiondiffusion_moe_tpu_torch.tools.visualize \\
        --run_dir ./checkpoints/t2m_moe_small \\
        --text "a person is running" --motion_length 120 \\
        --result_path test_sample.gif [--npy_path out.npy] [--device cpu]

``--run_dir`` is a run dir of either package's ``tools/train.py`` (the
port's steps or a JAX run's orbax ones), read through
``tools/export.py::load_run`` (``--use_ema`` takes its EMA weights). The
motion is sampled by ``GenerationPipeline(..., micro_batch=1)`` on the card
(``--device cpu`` for the CPU) from a generator seeded with ``--seed``,
denormalised with the run's ``meta/``, decoded by ``recover_from_ric`` on
the same device, smoothed by ``motion_temporal_filter(sigma=1.0)`` and
drawn by ``plot_3d_motion`` with the T2M or KIT chain of
``cfg.data.dataset_name``.
"""

from __future__ import annotations

import argparse

import numpy as np


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--run_dir", required=True,
                   help="training run dir containing config.json")
    p.add_argument("--text", required=True)
    p.add_argument("--motion_length", type=int, default=120,
                   help="frames at 20 fps, <= 196 (visualization.py:47-57)")
    p.add_argument("--result_path", default="test_sample.gif")
    p.add_argument("--npy_path", default="")
    p.add_argument("--sampler", default="ddpm", choices=["ddpm", "ddim", "dpm"])
    p.add_argument("--steps", type=int, default=0,
                   help="DDIM steps (0 = full schedule)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--use_ema", action="store_true",
                   help="sample with the EMA weights (run must be trained "
                        "with --ema_decay > 0)")
    p.add_argument("--device", default="cuda",
                   help="torch device to sample on (default: the card)")
    return p


def main(argv=None) -> np.ndarray:
    """Runs the CLI; returns the [T, J, 3] joints it drew."""
    args = build_argparser().parse_args(argv)

    import torch

    from motiondiffusion_moe_tpu_torch.data.normalizer import (
        MotionNormalizer)
    from motiondiffusion_moe_tpu_torch.motion import (
        KIT_KINEMATIC_CHAIN, T2M_KINEMATIC_CHAIN, recover_from_ric)
    from motiondiffusion_moe_tpu_torch.pipeline import GenerationPipeline
    from motiondiffusion_moe_tpu_torch.tools.export import load_run
    from motiondiffusion_moe_tpu_torch.utils.plot import (
        motion_temporal_filter, plot_3d_motion)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is "
                           "available (pass --device cpu to sample on the "
                           "CPU)")
    cfg, params, step, normalizer = load_run(args.run_dir,
                                             use_ema=args.use_ema)
    print(f"[visualize] restored step {step}")
    if normalizer is None:
        normalizer = MotionNormalizer.identity(cfg.data.dim_pose)

    pipe = GenerationPipeline(cfg, params=params, sampler=args.sampler,
                              num_inference_steps=args.steps or None,
                              micro_batch=1, device=device)
    generator = torch.Generator(device).manual_seed(args.seed)
    motion = pipe.generate([args.text], [args.motion_length],
                           generator=generator)[0]
    motion = normalizer.denormalize_np(motion)

    joints = recover_from_ric(torch.from_numpy(motion).to(device),
                              cfg.data.num_joints).cpu().numpy()
    joints = motion_temporal_filter(joints, sigma=1.0)
    if args.npy_path:
        np.save(args.npy_path, joints)
        print(f"[visualize] joints -> {args.npy_path}")

    chain = (T2M_KINEMATIC_CHAIN if cfg.data.dataset_name == "t2m"
             else KIT_KINEMATIC_CHAIN)
    plot_3d_motion(args.result_path, chain, joints, title=args.text, fps=20)
    print(f"[visualize] gif -> {args.result_path}")
    return joints


if __name__ == "__main__":
    main()
