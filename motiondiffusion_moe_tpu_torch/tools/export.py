"""Export a model as a self-contained serving artifact, and read one back.

The counterpart of ``motiondiffusion_moe_tpu/tools/export.py``, in the same
format and without flax::

    export/
      config.json       # the ExperimentConfig (both packages read it)
      params.msgpack    # ONE flax-msgpack blob: {"params": flax tree}
      meta/             # normalizer mean/std (when the run has them)
      export.json       # provenance: step, ema, dtype

The tree is the JAX package's named flax layout
(``models/bridge.py::state_dict_to_jax``), written by
``utils/flax_msgpack.py``: the JAX package's ``load_export`` and
``GenerationPipeline.from_export`` read the port's export, and the port's
:func:`load_export` / ``GenerationPipeline.from_export`` read the JAX
package's. ``--dtype bfloat16`` stores the weights bf16 except the FAVOR+
random-feature projections, as the JAX export does.

``--run_dir`` is a run dir of either package's ``tools/train.py``:
``config.json``, ``meta/`` and ``ckpt/``, which holds the port's
``step_<N>.pt`` files or a JAX run's orbax steps ``<N>/`` (read without
orbax, tensorstore or JAX; ``training/checkpoint.py``).

Usage::

    python -m motiondiffusion_moe_tpu_torch.tools.export \\
        --run_dir ./checkpoints/t2m_moe_small --use_ema --dtype bfloat16
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Mapping, Optional

import torch

from motiondiffusion_moe_tpu_torch.config import ExperimentConfig
from motiondiffusion_moe_tpu_torch.data.normalizer import MotionNormalizer
from motiondiffusion_moe_tpu_torch.pipeline import serving_dtype

_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def cast_serving_dtype(sd: Mapping[str, torch.Tensor],
                       dtype_name: Optional[str]) -> Dict[str, torch.Tensor]:
    """A copy of the state_dict with each float32 leaf in the serving dtype
    (``"float32"`` / ``""`` / None: unchanged; ``"bfloat16"``), except the
    FAVOR+ random-feature projections, which stay float32: the JAX export's
    leaf rule."""
    dtype = _DTYPES[dtype_name or "float32"]
    return {k: v.to(serving_dtype(k, v.dtype, dtype)) for k, v in sd.items()}


def local_shard(sd: Mapping[str, torch.Tensor], mesh
                ) -> Dict[str, torch.Tensor]:
    """The rank's cut of a global state_dict under ``mesh`` (an
    ``ExpertMesh``; None: ``sd`` itself), each cut copied so that the whole
    can be freed."""
    if mesh is None:
        return dict(sd)
    return {n: mesh.local_leaf(n, v).clone() for n, v in sd.items()}


def artifact_bytes(path: str) -> int:
    """The bytes on disk of an export (its ``params.msgpack``) or of a run
    dir's checkpoints (everything under ``ckpt/``)."""
    blob = os.path.join(path, "params.msgpack")
    if os.path.isfile(blob):
        return os.path.getsize(blob)
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(os.path.join(path, "ckpt"))
               for f in files)


def load_run(run_dir: str, step: Optional[int] = None,
             use_ema: bool = False, mesh=None):
    """A run dir of either package's ``tools/train.py`` -> (cfg, state_dict
    on the CPU, step, normalizer or None): the checkpoint at ``step``
    (default the newest; the port's format or a JAX run's orbax steps), its
    EMA weights with ``use_ema``; under ``mesh`` the rank's shard of the
    state_dict (:func:`local_shard`)."""
    from motiondiffusion_moe_tpu_torch.models.transformer import (
        MotionTransformer)
    from motiondiffusion_moe_tpu_torch.training.checkpoint import (
        CheckpointManager)

    cfg = ExperimentConfig.load(os.path.join(run_dir, "config.json"))
    ckpt_dir = os.path.join(run_dir, "ckpt")
    weights = "ema_params" if use_ema else "params"
    payload = (CheckpointManager(ckpt_dir, cfg=cfg).read(step,
                                                         weights=weights)
               if os.path.isdir(ckpt_dir) else None)
    if payload is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    if not use_ema:
        sd = payload["params"]
    else:
        if "ema_params" not in payload:
            raise ValueError(
                "this run has no EMA weights (trained with ema_decay=0); "
                "drop --use_ema or retrain with --ema_decay")
        # the EMA keeps model.parameters() in order
        with torch.device("meta"):
            names = [n for n, _ in MotionTransformer(
                cfg.model, use_kernels=False).named_parameters()]
        ema = payload["ema_params"]["params"]
        if len(ema) != len(names):
            raise ValueError(f"{len(ema)} EMA tensors for {len(names)} "
                             "parameters")
        sd = dict(zip(names, ema))
    meta = os.path.join(run_dir, "meta")
    normalizer = MotionNormalizer.load(meta) if os.path.isdir(meta) else None
    return cfg, local_shard(sd, mesh), int(payload["step"]), normalizer


def export_model(model, cfg: ExperimentConfig, out_dir: str, *,
                 dtype: str = "float32",
                 normalizer: Optional[MotionNormalizer] = None,
                 step: int = 0, use_ema: bool = False) -> str:
    """Write the serving artifact of ``model`` (a ``MotionTransformer`` or
    its state_dict) to ``out_dir``; returns ``out_dir``."""
    from motiondiffusion_moe_tpu_torch.models.bridge import state_dict_to_jax
    from motiondiffusion_moe_tpu_torch.utils.flax_msgpack import (
        msgpack_serialize)

    sd = model if isinstance(model, Mapping) else model.state_dict()
    sd = cast_serving_dtype(sd, dtype)
    tree = state_dict_to_jax(sd, cfg.model)
    os.makedirs(out_dir, exist_ok=True)
    cfg.save(os.path.join(out_dir, "config.json"))
    with open(os.path.join(out_dir, "params.msgpack"), "wb") as f:
        f.write(msgpack_serialize({"params": tree}))
    if normalizer is not None:
        normalizer.save(os.path.join(out_dir, "meta"))
    with open(os.path.join(out_dir, "export.json"), "w") as f:
        json.dump({"step": int(step), "use_ema": bool(use_ema),
                   "dtype": dtype or "float32"}, f, indent=2)
    print(f"[export] step {int(step)} (ema={use_ema}, "
          f"dtype={dtype or 'float32'}) -> {out_dir}")
    return out_dir


def export_run(run_dir: str, out_dir: str = "", *, step=None,
               use_ema: bool = False, dtype: str = "float32") -> str:
    """Write the serving artifact of a run dir of either package (default
    ``<run_dir>/export``); returns the export directory."""
    cfg, sd, step, normalizer = load_run(run_dir, step, use_ema)
    return export_model(sd, cfg, out_dir or os.path.join(run_dir, "export"),
                        dtype=dtype, normalizer=normalizer, step=step,
                        use_ema=use_ema)


def load_export(export_dir: str, mesh=None):
    """An export dir of either package -> (cfg, params, normalizer):
    ``params`` is the file's tree (``{"params": flax tree}``; bf16 leaves as
    ``torch.bfloat16`` tensors), or under ``mesh`` the rank's shard of it as
    a state_dict (:func:`local_shard`); the normalizer the identity when
    the export has no ``meta/``."""
    from motiondiffusion_moe_tpu_torch.utils.flax_msgpack import (
        msgpack_restore)

    cfg = ExperimentConfig.load(os.path.join(export_dir, "config.json"))
    path = os.path.join(export_dir, "params.msgpack")
    buf = bytearray(os.path.getsize(path))  # writable: the leaves share it
    view = memoryview(buf)
    with open(path, "rb") as f:
        got = 0
        while got < len(buf):
            n = f.readinto(view[got:])
            if not n:
                raise OSError(f"{path}: short read")
            got += n
    params = msgpack_restore(buf)
    if mesh is not None:
        from motiondiffusion_moe_tpu_torch.models.bridge import (
            jax_to_state_dict)

        params = local_shard(jax_to_state_dict(params), mesh)
    meta = os.path.join(export_dir, "meta")
    normalizer = (MotionNormalizer.load(meta) if os.path.isdir(meta)
                  else MotionNormalizer.identity(cfg.data.dim_pose))
    return cfg, params, normalizer


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--run_dir", required=True,
                   help="the port's training run dir (config.json + ckpt/)")
    p.add_argument("--out", default="",
                   help="output dir (default <run_dir>/export)")
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step (default latest)")
    p.add_argument("--use_ema", action="store_true",
                   help="export the EMA weights (run must be trained with "
                        "--ema_decay > 0)")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="stored weight dtype (bfloat16 halves the artifact; "
                        "FAVOR projections stay float32)")
    args = p.parse_args(argv)
    export_run(args.run_dir, args.out, step=args.step,
               use_ema=args.use_ema, dtype=args.dtype)


if __name__ == "__main__":
    main()
