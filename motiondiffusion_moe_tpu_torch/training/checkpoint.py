"""Checkpoints with auto-resume, torch-native.

Port of ``motiondiffusion_moe_tpu/training/checkpoint.py``: one file per
saved step (``step_<N>.pt``, written to a temporary name and renamed, so a
crash never leaves a torn checkpoint) holding the parameters, the optimizer
state, the step, the epoch, the EMA weights and the state of the trainer's
``torch.Generator``; a rolling window of the newest ``max_to_keep``. As with
orbax, saving a step that already exists is skipped.

The ``epoch_meta.json`` sidecar keeps its semantics (``:122-163``): a
cadence save that lands on an epoch's last step stores the in-progress
epoch, and the end-of-epoch save of the same step is then skipped, so the
trainer records "step S completed epoch E, resume at E + 1" in a small JSON
file next to the checkpoints; restore honours it when it matches the
restored step. (Resuming at the epoch after the checkpointed one is this
package's own choice, not the reference trainer's.)
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Optional, Tuple

import torch

_STEP_FILE = re.compile(r"step_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step)}.pt")

    def all_steps(self):
        return sorted(int(m.group(1)) for m in
                      map(_STEP_FILE.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state, epoch: int,
             generator: Optional[torch.Generator] = None) -> None:
        """Save ``state`` (a :class:`TrainState`) at ``step``; skipped when
        that step is saved already. Drops the oldest beyond
        ``max_to_keep``."""
        path = self._path(step)
        if os.path.exists(path):
            return
        payload = {
            "params": state.model.state_dict(),
            "opt_state": state.optimizer.state_dict(),
            "step": int(state.step),
            "epoch": int(epoch),
            "rng": None if generator is None else generator.get_state(),
        }
        if state.ema is not None:
            payload["ema_params"] = state.ema.state_dict()
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        for old in self.all_steps()[:-self.max_to_keep]:
            os.unlink(self._path(old))

    # -- epoch-completion sidecar ------------------------------------------

    def mark_epoch_complete(self, step: int, next_epoch: int) -> None:
        """Record that the checkpoint at ``step`` sits on an epoch boundary
        and a resume should start at ``next_epoch``. One entry per step;
        crash-safe (tmp + rename): losing the marker just falls back to a
        one-epoch replay."""
        path = os.path.join(self.directory, "epoch_meta.json")
        meta = self._read_epoch_meta()
        meta[str(int(step))] = int(next_epoch)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, path)

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

    def read(self, step: Optional[int] = None) -> Optional[dict]:
        """The saved payload at ``step`` (default the newest) on the CPU, or
        None when no checkpoint exists: ``params`` (the model's
        state_dict), ``opt_state``, ``step``, ``epoch``, ``rng`` and, when
        the run keeps one, ``ema_params``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        return torch.load(self._path(step), map_location="cpu",
                          weights_only=True)

    def restore_with_rng(self, state, step: Optional[int] = None
                         ) -> Optional[Tuple[object, int,
                                             Optional[torch.Tensor]]]:
        """Restore into ``state`` in place; returns (state, epoch, the saved
        generator state or None), or None when no checkpoint exists. An EMA
        the checkpoint lacks is seeded from the restored weights; an EMA
        the live state lacks is dropped with a warning."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        payload = self.read(step)
        state.model.load_state_dict(payload["params"])
        state.optimizer.load_state_dict(payload["opt_state"])
        state.step = int(payload["step"])
        if state.ema is not None:
            if "ema_params" in payload:
                state.ema.load_state_dict(payload["ema_params"])
            else:  # checkpoint predates EMA: seed from the restored weights
                state.ema.params = [p.detach().clone()
                                    for p in state.model.parameters()]
        elif "ema_params" in payload:
            print(f"[checkpoint] WARNING: checkpoint at step {step} carries "
                  "EMA weights but the current config has ema_decay=0 — the "
                  "EMA weights are DROPPED and later checkpoints will not "
                  "contain them. Resume with --ema_decay to keep them.")
        epoch = self._epoch_override(step, int(payload["epoch"]))
        return state, epoch, payload["rng"]
