"""The port's Trainer, checkpoints and training CLI on the CPU, at a tiny
width: fit, save and resume (the epoch-boundary case the ``epoch_meta.json``
sidecar fixes), the rolling window, the EMA and generator state, ``steps_per_call``, and
``tools/train.py main()``."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from motiondiffusion_moe_tpu_torch.config import ParallelConfig
from motiondiffusion_moe_tpu_torch.data.dataset import (
    SyntheticText2MotionDataset,
)
from motiondiffusion_moe_tpu_torch.data.loader import DataLoader
from motiondiffusion_moe_tpu_torch.tools import train as train_cli
from motiondiffusion_moe_tpu_torch.training.checkpoint import (
    CheckpointManager,
)
from motiondiffusion_moe_tpu_torch.training.trainer import Trainer

from tests._torch_parity import tiny_config, to_port


def _cfg(**train):
    cfg = to_port(tiny_config(num_layers=1))
    base = dict(num_epochs=1, batch_size=4, log_every=1,
                save_latest_every=1000)
    base.update(train)
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                              **base))


def _loader(cfg, size=8):
    ds = SyntheticText2MotionDataset(cfg.data, size=size, seed=0)
    return DataLoader(ds, batch_size=cfg.train.batch_size, seed=0)


def _fit(cfg, ckpt=None, size=8):
    trainer = Trainer(cfg, device="cpu")
    return trainer.fit(trainer.init_state(), _loader(cfg, size),
                       checkpoints=ckpt)


def _params(state):
    return [p.detach().clone() for p in state.model.parameters()]


def test_fit_runs_the_cond_uncond_double_step():
    state = _fit(_cfg(num_epochs=2))
    assert state.step == 2 * 2 * 2  # epochs x batches x (cond, uncond)
    assert all(torch.isfinite(p).all() for p in state.model.parameters())


def test_resume_from_epoch_boundary_runs_only_the_remaining_epoch(tmp_path):
    """A cadence save on an epoch's last step keeps the in-progress epoch
    and the end-of-epoch save of that step is skipped; the sidecar marker
    makes the resume start the next epoch instead of re-running this one."""
    cfg = _cfg(uncond_step=False, save_latest_every=1)
    mngr = CheckpointManager(str(tmp_path / "ckpt"))
    _fit(cfg, mngr, size=4)  # one step per epoch
    assert mngr.latest_step() == 1
    meta = json.loads((tmp_path / "ckpt" / "epoch_meta.json").read_text())
    assert meta == {"1": 1}
    cfg2 = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                              num_epochs=2))
    final = _fit(cfg2, CheckpointManager(str(tmp_path / "ckpt")), size=4)
    assert final.step == 2  # exactly one more epoch


def test_epoch_sidecar_overrides_a_skipped_duplicate_save(tmp_path):
    cfg = _cfg(ema_decay=0.9)
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state()
    mngr = CheckpointManager(str(tmp_path), max_to_keep=2)
    gen = torch.Generator().manual_seed(5)
    mngr.save(1, state, epoch=0, generator=gen)
    mngr.save(1, state, epoch=1, generator=gen)  # same step: skipped

    def epoch(step=None):
        fresh = Trainer(cfg, device="cpu").init_state()
        return mngr.restore_with_rng(fresh, step)[1]

    assert epoch() == 0
    mngr.mark_epoch_complete(1, 1)
    assert epoch() == 1
    for s in (2, 3):
        mngr.save(s, state, epoch=0, generator=gen)
    assert mngr.all_steps() == [2, 3]  # rolling max_to_keep
    assert epoch(3) == 0  # the marker belongs to step 1 only


def test_checkpoint_restores_params_optimizer_ema_and_generator(tmp_path):
    cfg = _cfg(ema_decay=0.9)
    mngr = CheckpointManager(str(tmp_path))
    trainer = Trainer(cfg, device="cpu")
    state = trainer.fit(trainer.init_state(), _loader(cfg))
    gen = torch.Generator().manual_seed(3)
    torch.rand(4, generator=gen)
    mngr.save(state.step, state, epoch=1, generator=gen)
    fresh = Trainer(cfg, device="cpu").init_state()
    restored, epoch, rng = mngr.restore_with_rng(fresh)
    assert (restored.step, epoch) == (state.step, 1)
    for a, b in zip(_params(restored), _params(state)):
        assert torch.equal(a, b)
    assert restored.optimizer.count == state.optimizer.count
    assert all(torch.equal(a, b) for a, b in zip(restored.optimizer.mu,
                                                 state.optimizer.mu))
    assert all(torch.equal(a, b) for a, b in zip(restored.ema.params,
                                                 state.ema.params))
    g2 = torch.Generator()
    g2.set_state(rng)
    assert torch.equal(torch.rand(4, generator=g2),
                       torch.rand(4, generator=gen))


def test_steps_per_call_has_the_single_step_semantics():
    a = _fit(_cfg())
    b = _fit(_cfg(steps_per_call=3))
    assert a.step == b.step == 4
    for x, y in zip(_params(a), _params(b)):
        assert torch.equal(x, y)


def test_loss_aware_sampler_sees_every_step_and_grad_accum_runs():
    cfg = _cfg(grad_accum_steps=2)
    cfg = dataclasses.replace(cfg, diffusion=dataclasses.replace(
        cfg.diffusion, schedule_sampler="loss-second-moment"))
    trainer = Trainer(cfg, device="cpu")
    trainer.fit(trainer.init_state(), _loader(cfg))
    assert trainer.sampler._loss_counts.sum() == 4 * 4  # 4 steps x B


def test_what_the_port_does_not_run_yet_raises():
    """The JAX compilation flags. The data, seq, pipe, expert and model
    axes run (tests/test_torch_parallel.py, tests/test_torch_seq_training.
    py, tests/test_torch_pipeline_parallel.py, tests/test_torch_moe_parallel.
    py, tests/test_torch_tensor_parallel.py); in one process, two data,
    seq, pipe, expert or model partitions or a launch given in part are a
    mismatch and raise ValueError."""
    cfg = to_port(tiny_config())
    for axis in ("num_data_partitions", "num_expert_partitions",
                 "num_model_partitions", "num_seq_partitions",
                 "num_pipeline_stages"):
        with pytest.raises(ValueError, match="1 process"):
            Trainer(dataclasses.replace(
                cfg, parallel=ParallelConfig(**{axis: 2})), device="cpu")
    for argv in (["--scan_blocks"], ["--remat_blocks", "dots"],
                 ["--pipeline_parallel", "2", "--scan_blocks"]):
        with pytest.raises(NotImplementedError):
            train_cli.main(["--dataset", "synthetic", "--device", "cpu"]
                           + argv)
    with pytest.raises(ValueError, match="1 process"):
        train_cli.main(["--dataset", "synthetic", "--device", "cpu",
                        "--expert_parallel", "2"])
    with pytest.raises(ValueError, match="in part"):
        train_cli.main(["--dataset", "synthetic", "--device", "cpu",
                        "--num_processes", "2"])


TINY_CLI = ["--dataset", "synthetic", "--num_layers", "1", "--latent_dim",
            "64", "--ff_size", "32", "--text_latent_dim", "16",
            "--batch_size", "2", "--synthetic_size", "4", "--log_every", "1"]


def test_train_cli_trains_on_cpu_and_resumes(tmp_path):
    argv = TINY_CLI + ["--device", "cpu", "--checkpoint_dir", str(tmp_path),
                       "--num_epochs", "1"]
    state = train_cli.main(argv)
    assert state.step == 4  # 2 batches x (cond, uncond)
    run = tmp_path / "t2m_moe_small"
    assert (run / "config.json").exists()
    assert (run / "meta" / "mean.npy").exists()
    assert os.listdir(run / "ckpt") == ["step_4.pt"]
    state = train_cli.main(argv[:-1] + ["2"])
    assert state.step == 8
    np.testing.assert_array_equal(
        sorted(os.listdir(run / "ckpt")), ["step_4.pt", "step_8.pt"])


def test_train_cli_on_cuda_without_a_gpu_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(TINY_CLI + ["--checkpoint_dir", str(tmp_path)])
