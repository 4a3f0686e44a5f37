"""Loader-throughput microbenchmark: native (C++) vs pure-Python batch path.

Port of ``motiondiffusion_moe_tpu/tools/bench_loader.py``, the JAX CLI's
flags plus ``--device``. The data plane assembles batches (crop + pad +
feat_bias z-norm) in GIL-free C++ threads (``native/motionio.cc``, built
by ``data/native.py``) wired through ``Text2MotionDataset.get_batch``.
This script measures both paths on one synthetic on-disk corpus, each
batch's motions placed on ``--device`` (the card by default) as the
trainer places them, and prints one JSON line with the speedup. Where the
JAX script skips the native path when its library is missing, this one
raises, as ``data/native.py`` does on a failed build.

Usage::

    python -m motiondiffusion_moe_tpu_torch.tools.bench_loader \\
        [--items 512] [--dim 263] [--batch 128] [--epochs 3] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np


def make_corpus(root: str, n_items: int, dim: int, seed: int = 0) -> None:
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "new_joint_vecs"), exist_ok=True)
    os.makedirs(os.path.join(root, "texts"), exist_ok=True)
    names = []
    for k in range(n_items):
        name = f"{k:06d}"
        T = int(rng.integers(60, 200))
        np.save(os.path.join(root, "new_joint_vecs", name + ".npy"),
                rng.standard_normal((T, dim)).astype(np.float32))
        with open(os.path.join(root, "texts", name + ".txt"), "w") as f:
            f.write(f"a person performs motion {k}#a/DET person/NOUN#0.0#0.0\n")
        names.append(name)
    with open(os.path.join(root, "train.txt"), "w") as f:
        f.write("\n".join(names))


def run_epochs(dataset, batch: int, epochs: int, device) -> float:
    """Items per second over ``epochs`` epochs, each batch's motions
    placed on ``device`` (the copies waited for before the clock stops)."""
    import torch

    from motiondiffusion_moe_tpu_torch.data.loader import DataLoader

    loader = DataLoader(dataset, batch_size=batch, seed=0, prefetch=False)
    # warmup one batch (touches every code path once)
    next(iter(loader))
    t0 = time.perf_counter()
    n = 0
    for e in range(epochs):
        loader.set_epoch(e)
        for _, motions, _ in loader:
            torch.from_numpy(motions).to(device, non_blocking=True)
            n += motions.shape[0]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    return n / dt


def main(argv=None) -> dict:
    """Runs the benchmark; returns the JSON object it prints."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--items", type=int, default=512)
    ap.add_argument("--dim", type=int, default=263)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="torch device the batches go to (default: the "
                         "card)")
    args = ap.parse_args(argv)

    import torch

    from motiondiffusion_moe_tpu_torch.config import DataConfig
    from motiondiffusion_moe_tpu_torch.data.dataset import Text2MotionDataset
    from motiondiffusion_moe_tpu_torch.data.normalizer import (
        MotionNormalizer)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is "
                           "available (pass --device cpu)")
    with tempfile.TemporaryDirectory() as root:
        make_corpus(root, args.items, args.dim)
        cfg = DataConfig(data_root=root, dim_pose=args.dim, num_joints=22,
                         max_motion_length=196, min_motion_length=40)
        norm = MotionNormalizer(np.zeros(args.dim, np.float32),
                                np.ones(args.dim, np.float32))

        py_ds = Text2MotionDataset(cfg, "train", normalizer=norm,
                                   use_native=False)
        py_ips = run_epochs(py_ds, args.batch, args.epochs, device)

        # raises when the native library cannot be built or loaded
        nat_ds = Text2MotionDataset(cfg, "train", normalizer=norm,
                                    use_native=True)
        assert nat_ds.has_native
        nat_ips = run_epochs(nat_ds, args.batch, args.epochs, device)

    result = {
        "metric": "loader items/s (crop+pad+normalize)",
        "python_items_per_s": round(py_ips, 1),
        "native_items_per_s": round(nat_ips, 1),
        "speedup": round(nat_ips / py_ips, 2),
        "items": args.items, "dim": args.dim, "batch": args.batch,
        "device": str(device),
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
