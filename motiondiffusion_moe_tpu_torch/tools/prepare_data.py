"""Dataset preparation CLI: raw joints -> training-ready feature dataset.

The counterpart of ``python -m motiondiffusion_moe_tpu.tools.prepare_data``,
with the same flags plus ``--device``: walk a directory of raw world-space
joint clips (``<id>.npy``, ``[T, J, 3]`` or ``[T, J*3]``), run
``process_file`` on each clip on the device, check each clip through the
``recover_from_ric`` round trip, and write the same layout:

    <out_dir>/new_joint_vecs/<id>.npy   [T-1, D] features (training input)
    <out_dir>/new_joints/<id>.npy       [T-1, J, 3] recovered joints
    <out_dir>/Mean.npy, Std.npy         raw per-channel stats (no feat_bias)
    <out_dir>/meta/mean.npy, std.npy    feat_bias-adjusted stats
                                        (the MotionNormalizer layout)

With ``texts/<id>.txt`` and ``train.txt`` beside them the directory is a
``Text2MotionDataset`` input (``tools/train.py --dataset t2m|kit``).

Usage::

    python -m motiondiffusion_moe_tpu_torch.tools.prepare_data \\
        --dataset t2m --joints_dir raw/joints --out_dir data/HumanML3D

Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

# per-dataset example clip (the canonical target skeleton) and frame rate
_DATASET = {
    "t2m": dict(example_id="000021", fps=20.0),
    "kit": dict(example_id="03950_gt", fps=12.5),
}


def _load_joints(path: str, joints_num: int) -> np.ndarray:
    """One raw clip as [T, joints_num, 3] (flat [T, J*3] accepted); joints
    past joints_num are dropped."""
    arr = np.load(path)
    if arr.ndim == 2:
        arr = arr.reshape(len(arr), -1, 3)
    if arr.ndim != 3 or arr.shape[-1] != 3:
        raise ValueError(f"{path}: expected [T, J, 3] joints, got {arr.shape}")
    if arr.shape[1] < joints_num:
        raise ValueError(f"{path}: {arr.shape[1]} joints < {joints_num}")
    return np.asarray(arr[:, :joints_num], dtype=np.float32)


def _kit_rename(source_file: str) -> str:
    """KIT file ids: ``03950_mmm_00.npy`` -> ``03950mmm.npy`` (the 7-char
    suffix cut, underscores dropped)."""
    return "".join(source_file[:-7].split("_")) + ".npy"


def prepare_dataset(joints_dir: str, out_dir: str, dataset: str = "t2m",
                    example_id: str | None = None, feat_bias: float = 25.0,
                    min_frames: int = 2, device="cuda") -> dict:
    """Run the whole preparation on ``device``; returns a summary (clips
    kept and skipped, frames, feature dim). A clip that fails (too short,
    degenerate geometry, non-finite features or round trip) is skipped and
    named; a device that is not there raises."""
    import torch

    from motiondiffusion_moe_tpu_torch.data.normalizer import (
        MotionNormalizer)
    from motiondiffusion_moe_tpu_torch.motion import recover_from_ric
    from motiondiffusion_moe_tpu_torch.motion.process import (
        ProcessConfig, build_target_offsets, process_file)

    if dataset not in _DATASET:
        raise ValueError(f"unknown dataset {dataset!r} (t2m | kit)")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {device}: no CUDA device is available "
                           "(pass --device cpu to prepare on the CPU)")
    consts = _DATASET[dataset]
    cfg = ProcessConfig.t2m() if dataset == "t2m" else ProcessConfig.kit()
    example_id = example_id or consts["example_id"]

    example_path = os.path.join(joints_dir, example_id + ".npy")
    if not os.path.isfile(example_path):
        raise FileNotFoundError(
            f"example clip {example_path} not found — pass --example_id "
            "naming a clip that exists in --joints_dir (it defines the "
            "canonical target skeleton)")
    tgt_offsets = build_target_offsets(
        _load_joints(example_path, cfg.joints_num), cfg, device)

    vec_dir = os.path.join(out_dir, "new_joint_vecs")
    jnt_dir = os.path.join(out_dir, "new_joints")
    os.makedirs(vec_dir, exist_ok=True)
    os.makedirs(jnt_dir, exist_ok=True)

    kept, skipped, frame_num = [], [], 0
    d = s1 = s2 = None  # float64 running sums over every frame
    source_list = sorted(f for f in os.listdir(joints_dir)
                         if f.endswith(".npy"))
    if not source_list:
        raise FileNotFoundError(f"no .npy clips under {joints_dir}")
    for source_file in source_list:
        name = _kit_rename(source_file) if dataset == "kit" else source_file
        try:
            joints = _load_joints(os.path.join(joints_dir, source_file),
                                  cfg.joints_num)
            if len(joints) < min_frames:
                raise ValueError(f"only {len(joints)} frames")
            data, _, _, _ = process_file(joints, cfg, tgt_offsets, device)
            # the decode round trip: a NaN means degenerate geometry (e.g.
            # zero-length bones) and the clip is dropped
            rec = recover_from_ric(torch.as_tensor(data, device=device),
                                   cfg.joints_num).cpu().numpy()
            if not (np.isfinite(data).all() and np.isfinite(rec).all()):
                raise ValueError("non-finite features/recovered joints")
        except (ValueError, OSError) as e:
            skipped.append((source_file, str(e)))
            print(f"[prepare_data] skip {source_file}: {e}")
            continue
        np.save(os.path.join(vec_dir, name), data)
        np.save(os.path.join(jnt_dir, name), rec)
        frame_num += data.shape[0]
        if s1 is None:
            d = data.shape[-1]
            s1 = np.zeros(d, np.float64)
            s2 = np.zeros(d, np.float64)
        s1 += data.sum(axis=0, dtype=np.float64)
        s2 += (data.astype(np.float64) ** 2).sum(axis=0)
        kept.append(name)

    if not kept:
        raise RuntimeError("every clip failed processing — nothing to save")
    mean = s1 / frame_num
    std = np.sqrt(np.maximum(s2 / frame_num - mean ** 2, 0.0))
    np.save(os.path.join(out_dir, "Mean.npy"), mean.astype(np.float32))
    np.save(os.path.join(out_dir, "Std.npy"), std.astype(np.float32))
    MotionNormalizer(mean, MotionNormalizer.apply_feat_bias(
        std, cfg.joints_num, feat_bias)).save(os.path.join(out_dir, "meta"))

    minutes = frame_num / consts["fps"] / 60.0
    print(f"[prepare_data] {dataset}: {len(kept)} clips kept, "
          f"{len(skipped)} skipped, {frame_num} frames "
          f"({minutes:.1f} min @ {consts['fps']} fps) on {device} "
          f"-> {out_dir}")
    return {"kept": len(kept), "skipped": len(skipped),
            "frames": frame_num, "dim": int(d)}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        description="Raw joints -> a HumanML3D / KIT-ML feature dataset "
                    "(PyTorch port)")
    p.add_argument("--dataset", default="t2m", choices=["t2m", "kit"])
    p.add_argument("--joints_dir", required=True,
                   help="directory of raw [T, J, 3] world-joint .npy clips")
    p.add_argument("--out_dir", required=True,
                   help="output dataset root (new_joint_vecs/, new_joints/,"
                        " Mean/Std, meta/)")
    p.add_argument("--example_id", default="",
                   help="clip id defining the canonical target skeleton "
                        "(default: the reference's per-dataset id)")
    p.add_argument("--feat_bias", type=float, default=25.0,
                   help="root / foot-contact std divisor")
    p.add_argument("--device", default="cuda",
                   help="torch device of the feature math (default cuda; "
                        "raises when it is not available)")
    args = p.parse_args(argv)
    return prepare_dataset(args.joints_dir, args.out_dir, args.dataset,
                           example_id=args.example_id or None,
                           feat_bias=args.feat_bias, device=args.device)


if __name__ == "__main__":
    main()
