"""Checkpoints with auto-resume, in the port's format or in the JAX
package's.

Port of ``motiondiffusion_moe_tpu/training/checkpoint.py``. A directory's
format is what it holds:

- ``step_<N>.pt`` (the port's own): one file per saved step, written to a
  temporary name and renamed, holding the parameters, the optimizer state,
  the step, the epoch, the EMA weights and the state of the trainer's
  ``torch.Generator``;
- ``<N>/default/_METADATA`` (a JAX run's orbax steps): read through
  ``utils/orbax_format.py`` (OCDBT or plain zarr) and written in orbax's
  plain layout, which the JAX package's ``CheckpointManager`` restores, so
  that a run moves between the packages in both directions.

A directory holding both raises; an empty one takes the port's format
unless the constructor is given ``fmt="orbax"``. Either way
:meth:`CheckpointManager.read` gives the port's own payload, a rolling
window of the newest ``max_to_keep`` steps is kept, and saving a step that
exists already is skipped, as orbax does.

A JAX step's payload: ``params`` is the ``params`` collection through
``models/bridge.py::jax_to_state_dict``; the sown ``moe_losses`` /
``moe_metrics`` collections beside it (per-step values the forward never
reads) and their Adam moments are kept by the manager as read and written
back on the next save (zeros for a state that never saw a JAX step), as are
the moments of the frozen FAVOR+ projections, which the port's optimizer
leaves out. ``opt_state`` is Adam's ``count`` (``opt_state.1.0.count``,
which must equal the schedule's ``opt_state.1.1.count`` when the learning
rate has one) and ``mu`` / ``nu``, each leaf transformed as its parameter
is and kept in its stored dtype, in the order of the optimizer's
parameters. A JAX key cannot become a ``torch.Generator`` state: a JAX step
has ``rng`` None, and the trainer then seeds its generator with
:func:`resume_seed`. A step the port writes in the JAX layout keeps the
generator's state in ``<N>/torch_generator.pt``, which the JAX restore
ignores, and saves ``has_rng=False``.

The ``epoch_meta.json`` sidecar keeps its semantics (``:122-163``) and its
name in both formats: a cadence save that lands on an epoch's last step
stores the in-progress epoch, and the end-of-epoch save of the same step is
then skipped, so the trainer records "step S completed epoch E, resume at
E + 1" in a small JSON file next to the checkpoints; restore honours it
when it matches the restored step. (Resuming at the epoch after the
checkpointed one is this package's own choice, not the reference
trainer's.)

Under data, seq, pipe, expert and model parallelism (``parallel/``) saving
is collective: every rank calls :meth:`CheckpointManager.save`, which gathers
into the primary's host memory the ZeRO-1 shards, the expert and model
blocks of the parameters, moments and EMA (experts in order on dim 0,
model blocks on the dim JAX's Megatron rule cuts, every pipe stage's blocks
under their one-process names: the global layout a one-process run and the
JAX package hold), and the generator state of each row-holder (the ranks
of a model group, of a seq group and of a pipe group draw alike: the states
of the ranks with ``s = p = m = 0``; ``rng`` is then the list of them,
in row-holder order, whatever ``sp`` and ``tp``); the primary writes either
format and ``epoch_meta.json``, and the others wait at a barrier. Every
rank reads a restore whole and keeps its blocks and its shard, so a run
saved at one ``(dp, sp, pp, ep, tp)`` resumes at any other, one process
included, and a run with as many row-holders takes their generator
states.
"""

from __future__ import annotations

import io
import json
import os
import re
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from motiondiffusion_moe_tpu_torch.parallel.distributed import (
    all_gather_objects,
    barrier,
    is_primary,
    primary_says,
    world_size,
)
from motiondiffusion_moe_tpu_torch.parallel.mesh import (
    local_state_dict,
    whole_model,
    whole_state_dict,
)
from motiondiffusion_moe_tpu_torch.utils import orbax_format

_STEP_FILE = re.compile(r"step_(\d+)\.pt$")
GENERATOR_FILE = "torch_generator.pt"
FORMATS = ("torch", "orbax")


def resume_seed(seed: int, step: int) -> int:
    """The seed of the trainer's generator when it resumes a step that
    holds no generator state (a JAX run's): ``(seed + 1) * 2**32 + step``.
    Not ``seed + 1``, the fresh run's seed, which would replay step 0's
    noise; one seed per (seed, step)."""
    return ((int(seed) + 1) * 2 ** 32 + int(step)) % 2 ** 64


def detect_format(directory: str) -> Optional[str]:
    """``"orbax"`` for a directory of JAX steps, ``"torch"`` for one of the
    port's, None when it holds neither; raises when it holds both."""
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return None
    jax_steps = [n for n in names if orbax_format.is_step_dir(n)
                 and os.path.isfile(os.path.join(directory, n, "default",
                                                 "_METADATA"))]
    port_steps = [n for n in names if _STEP_FILE.match(n)]
    if jax_steps and port_steps:
        raise ValueError(
            f"{directory} holds both a JAX run's orbax steps (e.g. "
            f"{sorted(jax_steps)[0]}/default/_METADATA) and the port's "
            f"(e.g. {sorted(port_steps)[0]}); move one of them out")
    return "orbax" if jax_steps else "torch" if port_steps else None


def _zeros_tree(tree, dtype=None):
    if isinstance(tree, dict):
        return {k: _zeros_tree(v, dtype) for k, v in tree.items()}
    return torch.zeros(tuple(tree.shape), dtype=dtype or tree.dtype)


def _layout(x) -> Tuple[tuple, str]:
    """(shape, dtype name) of a torch or numpy leaf."""
    name = (str(x.dtype).rpartition(".")[2] if isinstance(x, torch.Tensor)
            else np.dtype(x.dtype).name)
    return tuple(x.shape), name


def _set_path(tree: dict, path: Tuple[str, ...], value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


class CheckpointManager:
    """The checkpoints of one run (``<run>/ckpt``). ``cfg`` (the run's
    ``ExperimentConfig`` or ``ModelConfig``) gives the model's parameter
    order, which a JAX step needs; the port's format needs none."""

    def __init__(self, directory: str, max_to_keep: int = 5,
                 fmt: Optional[str] = None, cfg=None):
        if fmt is not None and fmt not in FORMATS:
            raise ValueError(f"unknown checkpoint format {fmt!r} "
                             f"({' | '.join(FORMATS)})")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        found = detect_format(self.directory)
        if fmt is not None and found is not None and fmt != found:
            raise ValueError(f"{self.directory} holds {found} checkpoints, "
                             f"not {fmt}")
        self.format = found or fmt or "torch"
        self.cfg = cfg
        # the JAX leaves the port does not hold (see the module doc), by
        # key path, from the last JAX step read
        self._extras: Dict[Tuple[str, ...], torch.Tensor] = {}

    def _path(self, step: int) -> str:
        if self.format == "orbax":
            return os.path.join(self.directory, str(int(step)))
        return os.path.join(self.directory, f"step_{int(step)}.pt")

    def all_steps(self) -> List[int]:
        names = os.listdir(self.directory)
        if self.format == "orbax":
            return sorted(int(n) for n in names if orbax_format.is_step_dir(n)
                          and os.path.isdir(os.path.join(self.directory, n)))
        return sorted(int(m.group(1)) for m in map(_STEP_FILE.match, names)
                      if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state, epoch: int,
             generator: Optional[torch.Generator] = None) -> None:
        """Save ``state`` (a :class:`TrainState`) at ``step``; skipped when
        that step is saved already. Drops the oldest beyond
        ``max_to_keep``. A collective under data parallelism (see the
        module doc)."""
        path = self._path(step)
        if primary_says(os.path.exists(path)):
            return
        params = whole_state_dict(state.model)
        opt = state.optimizer.state_dict()
        ema = state.ema.state_dict() if state.ema is not None else None
        rng = None if generator is None else generator.get_state()
        if world_size() > 1 and rng is not None:
            # one a row-holder, in q order: the ranks of a model group and
            # of a seq group draw alike
            mesh = state.optimizer.mesh
            rng = all_gather_objects(rng)
            if mesh is not None:
                rng = [rng[mesh.rank_of(d, e, 0)] for d in range(mesh.dp)
                       for e in range(mesh.ep)]
        if is_primary():
            self._write(path, state, epoch, params, opt, ema, rng)
        barrier()

    def _write(self, path: str, state, epoch: int, params: dict, opt: dict,
               ema: Optional[dict], rng) -> None:
        if self.format == "orbax":
            files = {}
            if rng is not None:
                buf = io.BytesIO()
                torch.save(rng, buf)
                files[GENERATOR_FILE] = buf.getvalue()
            orbax_format.write_step(path, self._jax_tree(
                state, epoch, params, opt, ema), files)
        else:
            payload = {
                "params": params,
                "opt_state": opt,
                "step": int(state.step),
                "epoch": int(epoch),
                "rng": rng,
            }
            if ema is not None:
                payload["ema_params"] = ema
            tmp = path + ".tmp"
            torch.save(payload, tmp)
            os.replace(tmp, path)
        for old in self.all_steps()[:-self.max_to_keep]:
            old_path = self._path(old)
            if os.path.isdir(old_path):
                shutil.rmtree(old_path)
            else:
                os.unlink(old_path)

    # -- epoch-completion sidecar ------------------------------------------

    def mark_epoch_complete(self, step: int, next_epoch: int) -> None:
        """Record that the checkpoint at ``step`` sits on an epoch boundary
        and a resume should start at ``next_epoch``. One entry per step;
        crash-safe (tmp + rename): losing the marker just falls back to a
        one-epoch replay. The primary writes; every rank waits for it."""
        if is_primary():
            path = os.path.join(self.directory, "epoch_meta.json")
            meta = self._read_epoch_meta()
            meta[str(int(step))] = int(next_epoch)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(meta, f)
            os.replace(tmp, path)
        barrier()

    def _read_epoch_meta(self) -> Dict[str, int]:
        try:
            with open(os.path.join(self.directory, "epoch_meta.json")) as f:
                meta = json.load(f)
        except (OSError, ValueError):
            return {}
        # legacy single-entry layout {"step": S, "next_epoch": E}
        if "step" in meta and "next_epoch" in meta:
            return {str(int(meta["step"])): int(meta["next_epoch"])}
        return {str(k): int(v) for k, v in meta.items()}

    def _epoch_override(self, step: int, epoch: int) -> int:
        return max(epoch, self._read_epoch_meta().get(str(step), epoch))

    # -- restore -----------------------------------------------------------

    def read(self, step: Optional[int] = None, model=None,
             weights: Optional[str] = None) -> Optional[dict]:
        """The saved payload at ``step`` (default the newest) on the CPU, or
        None when no checkpoint exists: ``params`` (the model's
        state_dict), ``opt_state`` (``count``, ``mu``, ``nu``), ``step``,
        ``epoch``, ``rng`` and, when the run keeps one, ``ema_params``. A
        JAX step needs the parameter order: of ``model`` when given, else
        of the constructor's ``cfg``. ``weights="params"`` or
        ``"ema_params"`` reads only that tree, the step and the epoch of a
        JAX step (a port step is one file, read whole)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        if self.format == "orbax":
            return self._from_jax(self._path(step), model, weights)
        return torch.load(self._path(step), map_location="cpu",
                          weights_only=True)

    def restore_with_rng(self, state, step: Optional[int] = None
                         ) -> Optional[Tuple[object, int,
                                             Optional[torch.Tensor]]]:
        """Restore into ``state`` in place; returns (state, epoch, the saved
        generator state: one, a list of one per rank, or None), or None
        when no checkpoint exists. An EMA
        the checkpoint lacks is seeded from the restored weights; an EMA
        the live state lacks is dropped with a warning."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        payload = self.read(step, model=whole_model(state.model))
        state.model.load_state_dict(local_state_dict(state.model,
                                                     payload["params"]))
        state.optimizer.load_state_dict(payload["opt_state"])
        state.step = int(payload["step"])
        if state.ema is not None:
            if "ema_params" in payload:
                state.ema.load_state_dict(payload["ema_params"])
            else:  # checkpoint predates EMA: seed from the restored weights
                state.ema.reset(state.model)
        elif "ema_params" in payload:
            print(f"[checkpoint] WARNING: checkpoint at step {step} carries "
                  "EMA weights but the current config has ema_decay=0 — the "
                  "EMA weights are DROPPED and later checkpoints will not "
                  "contain them. Resume with --ema_decay to keep them.")
        epoch = self._epoch_override(step, int(payload["epoch"]))
        return state, epoch, payload["rng"]

    # -- the JAX layout ------------------------------------------------------

    def _model(self, model=None):
        """``model``, or the run's model built on the meta device."""
        if model is not None:
            return model
        if self.cfg is None:
            raise ValueError(f"{self.directory}: a JAX run's checkpoint needs "
                             "the run's config (CheckpointManager(..., "
                             "cfg=...)) for the parameter order")
        from motiondiffusion_moe_tpu_torch.models.transformer import (
            MotionTransformer)
        with torch.device("meta"):
            return MotionTransformer(getattr(self.cfg, "model", self.cfg),
                                     use_kernels=False)

    @staticmethod
    def _flax_paths(model) -> Dict[str, Tuple[str, ...]]:
        """Each parameter's path in the flax ``params`` tree."""
        from motiondiffusion_moe_tpu_torch.models.bridge import flax_leaf
        modules = dict(model.named_modules())
        out = {}
        for name, p in model.named_parameters():
            parts, leaf, _ = flax_leaf(name, torch.empty(
                p.shape, device="meta"), modules)
            out[name] = tuple(parts) + (leaf,)
        return out

    def _from_jax(self, step_dir: str, model=None,
                  weights: Optional[str] = None) -> dict:
        from motiondiffusion_moe_tpu_torch.models.bridge import (
            jax_to_state_dict)

        def bridged(tree) -> Dict[str, torch.Tensor]:
            return jax_to_state_dict(tree["params"])

        model = self._model(model)
        named = list(model.named_parameters())
        names = [n for n, _ in named]
        top = None if weights is None else (weights, "step", "epoch")
        tree = orbax_format.read_step(step_dir, top)
        payload = {"step": int(tree["step"]), "epoch": int(tree["epoch"]),
                   "rng": None}
        adam = sched = None
        if weights is None:
            adam, sched = tree["opt_state"][1]
            count = int(adam["count"])
            if sched is not None and int(sched["count"]) != count:
                raise ValueError(f"{step_dir}: Adam's count {count} and the "
                                 f"schedule's {int(sched['count'])} differ")
        # the weight trees side by side: their copies release the GIL
        trees = {"params": tree.get("params"),
                 "ema": tree.get("ema_params"),
                 "mu": adam["mu"] if adam else None,
                 "nu": adam["nu"] if adam else None}
        with ThreadPoolExecutor(len(trees)) as pool:
            sds = {k: pool.submit(bridged, v) for k, v in trees.items()
                   if v is not None}
            sds = {k: f.result() for k, f in sds.items()}
        if "params" in sds:
            payload["params"] = sds["params"]
        if "ema" in sds:
            payload["ema_params"] = {"params": [sds["ema"][n]
                                                for n in names]}
        if weights is not None:
            return payload
        trainable = [n for n, p in named if p.requires_grad]
        mu, nu = sds["mu"], sds["nu"]
        payload["opt_state"] = {"count": count,
                                "mu": [mu[n] for n in trainable],
                                "nu": [nu[n] for n in trainable]}
        gen = os.path.join(step_dir, GENERATOR_FILE)
        if os.path.isfile(gen):
            payload["rng"] = torch.load(gen, weights_only=True)
        # what the port does not hold: the sown collections and their
        # moments, and the frozen parameters' moments
        paths = self._flax_paths(model)
        frozen = {paths[n] for n in names if n not in set(trainable)}
        extras = {}
        for parts, leaf in orbax_format.flatten(tree):
            keys = tuple(k for k, _ in parts)
            if leaf is None:
                continue
            if keys[0] == "params" and keys[1] != "params":
                extras[keys] = leaf
            elif keys[:3] == ("opt_state", "1", "0") and keys[3] in (
                    "mu", "nu") and (keys[4] != "params"
                                     or keys[5:] in frozen):
                extras[keys] = leaf
        self._extras = extras
        return payload

    def _jax_tree(self, state, epoch: int, params: dict, opt_state: dict,
                  ema: Optional[dict]) -> dict:
        """The JAX package's checkpoint tree of ``state``, given its
        model's, optimizer's and EMA's whole state dicts
        (``CheckpointManager.save`` there, ``:40-66``)."""
        from motiondiffusion_moe_tpu_torch.models.bridge import (
            state_dict_to_jax)
        from motiondiffusion_moe_tpu_torch.models.moe import SwitchMoELayer

        model, opt = whole_model(state.model), state.optimizer
        cfg = model.config
        named = list(model.named_parameters())
        trainable = [n for n, p in named if p.requires_grad]
        # the sown collections, zeros of their shapes: one per MoE layer
        colls: dict = {"moe_losses": {}, "moe_metrics": {}}
        paths = self._flax_paths(model)
        for name, m in model.named_modules():
            if isinstance(m, SwitchMoELayer):
                where = paths[f"{name}.w1"][:-1]
                E = m.num_experts
                _set_path(colls["moe_losses"], where + ("aux",),
                          torch.zeros(()))
                _set_path(colls["moe_metrics"], where + ("expert_usage",),
                          torch.zeros(E))
                _set_path(colls["moe_metrics"],
                          where + ("expert_importance",), torch.zeros(E))
        colls = {k: v for k, v in colls.items() if v}

        def moments(values, dtype) -> dict:
            sd = dict(zip(trainable, values))
            for n, p in named:   # the frozen parameters: zeros
                if n not in sd:
                    sd[n] = torch.zeros(params[n].shape,
                                        dtype=dtype or p.dtype)
            tree = {"params": state_dict_to_jax(sd, cfg)}
            tree.update(_zeros_tree(colls, dtype))
            return tree

        count = np.asarray(opt_state["count"], np.int32)
        adam = {"count": count, "mu": moments(opt_state["mu"], opt.mu_dtype),
                "nu": moments(opt_state["nu"], opt.nu_dtype)}
        tree = {
            "params": {"params": state_dict_to_jax(params, cfg),
                       **colls},
            "opt_state": [None, [adam, {"count": count}
                                 if callable(opt.lr) else None]],
            "step": np.asarray(state.step, np.int32),
            "epoch": np.asarray(epoch, np.int64),
            "rng": np.zeros(4, np.uint32),
            "rng_width": np.asarray(0, np.int64),
            "has_rng": np.asarray(False),
        }
        if ema is not None:
            tree["ema_params"] = {"params": state_dict_to_jax(
                dict(zip([n for n, _ in named], ema["params"])), cfg)}
        for keys, leaf in self._extras.items():
            node = tree
            for k in keys[:-1]:
                node = node[int(k)] if isinstance(node, list) else node.get(k)
                if node is None:
                    break
            else:
                old = node.get(keys[-1]) if isinstance(node, dict) else None
                if old is not None and _layout(old) == _layout(leaf):
                    node[keys[-1]] = leaf
        return tree
