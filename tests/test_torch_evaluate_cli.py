"""The port's evaluate CLI end to end on the CPU.

A tiny run trained by the port's ``tools/train.py`` (one epoch, 1 block
per scale, latent 32, 50 diffusion steps) is evaluated by
``tools/evaluate.py`` with a real-shaped ``finest.tar`` and the committed
29-word GloVe fixture, on ``--dataset synthetic`` and on a small corpus in
the HumanML3D layout (``--dataset real``), on the host path and with
``--device_embeddings``. The two paths embed the same motions (the same
generator, micro-batch for micro-batch), so replication 0's Matching
Score, R-precision and FID agree within 1e-4 relative (the encoder sees
other batch groupings).
"""

import os

import numpy as np
import pytest
import torch

from motiondiffusion_moe_tpu_torch.tools.evaluate import (
    build_argparser,
    main as eval_main,
)
from motiondiffusion_moe_tpu_torch.tools.train import main as train_main

from tests.test_torch_eval import _save_finest_tar

FIXTURE_GLOVE = os.path.join(os.path.dirname(__file__), "fixtures", "glove")
TINY = ["--device", "cpu", "--batch_size", "4", "--num_epochs", "1",
        "--num_layers", "1", "--latent_dim", "32", "--ff_size", "16",
        "--num_heads", "2", "--num_experts", "4", "--text_latent_dim", "16",
        "--diffusion_steps", "50", "--no_uncond_step"]
PROTOCOL = ["--device", "cpu", "--batch_size", "4", "--sampler", "ddim",
            "--steps", "5", "--mm_num_samples", "4", "--mm_num_repeats", "3",
            "--mm_num_times", "2", "--diversity_times", "4",
            "--protocol_batch_size", "4", "--glove_dir", FIXTURE_GLOVE]


@pytest.fixture(scope="module")
def finest(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("evaluator") / "finest.tar")
    _save_finest_tar(path)
    return path


@pytest.fixture(scope="module")
def synthetic_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("runs")
    train_main(TINY + ["--name", "evalrun", "--dataset", "synthetic",
                       "--synthetic_size", "8", "--checkpoint_dir",
                       str(root)])
    return str(root / "evalrun")


def _summary_finite(summary):
    for metric, per_model in summary.items():
        for model, (mean, ci) in per_model.items():
            assert np.all(np.isfinite(mean)) and np.all(np.isfinite(ci)), (
                metric, model)


def _rep0(result, model):
    """Replication 0's Matching Score, R-precision and (for the model) FID."""
    per = result["per_replication"]
    return [per[key][model][0] for key in ("Matching Score", "R_precision",
                                           "FID") if model in per[key]]


def test_synthetic_host_and_device_embedding_paths(synthetic_run, finest,
                                                   tmp_path, capsys):
    host = eval_main(PROTOCOL + [
        "--run_dir", synthetic_run, "--dataset", "synthetic",
        "--max_samples", "12", "--replication_times", "2",
        "--evaluator_ckpt", finest, "--log_file", str(tmp_path / "h.log")])
    out = capsys.readouterr().out
    assert "loaded evaluator weights" in out
    assert "hashed word vectors" not in out  # the GloVe fixture was read
    assert "MAE=" in out and "restored step 2" in out
    _summary_finite(host["summary"])
    mae, vel, jerk = host["joint"]
    assert mae.shape == (12,) and np.isfinite([*mae, vel, jerk]).all()
    log = (tmp_path / "h.log").read_text()
    for key in ("Matching Score", "R_precision", "FID", "Diversity",
                "MultiModality"):
        assert f"{key} Summary" in log
        assert len(host["per_replication"][key]["evalrun"]) == 2

    dev = eval_main(PROTOCOL + [
        "--run_dir", synthetic_run, "--dataset", "synthetic",
        "--max_samples", "12", "--replication_times", "1",
        "--evaluator_ckpt", finest, "--device_embeddings",
        "--skip_joint_scores", "--log_file", str(tmp_path / "d.log")])
    out = capsys.readouterr().out
    assert "generation+device-embed took" in out and "MAE=" not in out
    _summary_finite(dev["summary"])
    for name in ("evalrun", "ground truth"):
        assert len(_rep0(dev, name)) == (3 if name == "evalrun" else 2)
        for a, b in zip(_rep0(host, name), _rep0(dev, name)):
            np.testing.assert_allclose(a, b, rtol=1e-4)


def _write_corpus(root, n=14, seed=0):
    """A small corpus in the HumanML3D layout: 263-dim features, captions
    with tokens, whole-clip lines, train and test splits."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "new_joint_vecs"))
    os.makedirs(os.path.join(root, "texts"))
    ids = [f"{i:06d}" for i in range(n)]
    for i, name in enumerate(ids):
        frames = 40 + (i * 11) % 150
        motion = np.cumsum(0.05 * rng.standard_normal((frames, 263)),
                           axis=0).astype(np.float32)
        np.save(os.path.join(root, "new_joint_vecs", name + ".npy"), motion)
        verb = ["walk", "jump", "turn"][i % 3]
        with open(os.path.join(root, "texts", name + ".txt"), "w") as f:
            f.write(f"a person {verb}s left#a/DET person/NOUN {verb}/VERB "
                    f"left/ADV#0.0#0.0\n")
    for split in ("train", "test"):
        with open(os.path.join(root, f"{split}.txt"), "w") as f:
            f.write("\n".join(ids) + "\n")


def test_real_corpus(tmp_path, capsys):
    corpus = str(tmp_path / "HumanML3D")
    _write_corpus(corpus)
    train_main(TINY + ["--name", "realrun", "--dataset", "t2m",
                       "--data_root", corpus, "--no_native_io",
                       "--checkpoint_dir", str(tmp_path)])
    run_dir = str(tmp_path / "realrun")
    res = eval_main(PROTOCOL + ["--run_dir", run_dir,
                                "--replication_times", "1",
                                "--score_samples", "4"])
    out = capsys.readouterr().out
    assert "14 eval samples" in out and "random-init evaluator" in out
    assert "joint-space scores over 4/14" in out
    _summary_finite(res["summary"])
    assert res["joint"][0].shape == (4,)
    assert os.path.exists(os.path.join(run_dir, "evaluation.log"))
    # the ground-truth side is the corpus, normalised by the run's meta/
    assert res["per_replication"]["Matching Score"]["ground truth"]


@pytest.mark.parametrize("flag", ["--data_parallel", "--expert_parallel",
                                  "--tensor_parallel"])
def test_multi_device_flags_raise(flag):
    """In one process a degree above 1 raises: one process per device."""
    with pytest.raises(ValueError, match="one process per device"):
        eval_main(["--run_dir", "/nonexistent", flag, "2"])


def test_runs_on_the_card_by_default(synthetic_run):
    assert build_argparser().parse_args(["--run_dir", "x"]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            eval_main(["--run_dir", synthetic_run])
    with pytest.raises(ValueError, match="EMA"):
        eval_main(["--run_dir", synthetic_run, "--device", "cpu",
                   "--use_ema"])
