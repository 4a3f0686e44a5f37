"""The port's visualize, serving_quality, profile_bench, bench_loader and
soak_report CLIs on the CPU.

- ``visualize``: a tiny run dir (seeded flax weights bridged into the port,
  written through the port's ``CheckpointManager``, a seeded normalizer in
  ``meta/``, 263 features and 22 joints so that the T2M chain draws) goes
  through ``tools/visualize.py --device cpu`` (DDIM, 3 steps: no per-step
  noise). The ``--npy_path`` joints are held against JAX's sampler on the
  same weights with the port's initial noise injected, then the JAX
  package's normalizer, ``recover_from_ric`` and ``motion_temporal_filter``:
  the sampled features within 1e-5 x their largest value (the pipeline
  tests' bound), so the joints within 1e-4 x theirs (``recover_from_ric``
  sums velocities over the frames). The GIF has one frame per motion
  frame.
- ``serving_quality``: end to end on that run dir with a real-shaped
  seeded ``finest.tar`` (100-step schedule): finite statistics of every
  variant, the weights placed once per dtype.
- ``soak_report``: JSON equal to the JAX tool's on the same logs, and the
  log of the port's ``tools/train.py`` parsed line for line.
- ``profile_bench``: ``analyze`` on a CPU trace of a tiny denoiser forward
  (operators by self time) and on a trace of CUDA kernel events named as
  the port's kernels are; ``--scan > 1`` and a missing card raise.
- ``bench_loader``: native and Python paths on a 16-item corpus.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motiondiffusion_moe_tpu.data.normalizer import (
    MotionNormalizer as JaxMotionNormalizer,
)
from motiondiffusion_moe_tpu.diffusion import (
    ddim_sample_loop as jax_ddim_loop,
    make_schedule as jax_make_schedule,
    respace_schedule as jax_respace,
    space_timesteps as jax_space,
)
from motiondiffusion_moe_tpu.models.transformer import (
    MotionTransformer as JaxMotionTransformer,
)
from motiondiffusion_moe_tpu.motion.recover import (
    recover_from_ric as jax_recover_from_ric,
)
from motiondiffusion_moe_tpu.tools import soak_report as jax_soak
from motiondiffusion_moe_tpu.utils.plot import (
    motion_temporal_filter as jax_filter,
)
from motiondiffusion_moe_tpu_torch.data.normalizer import MotionNormalizer
from motiondiffusion_moe_tpu_torch.models.text_encoder import hash_tokenize
from motiondiffusion_moe_tpu_torch.models.transformer import MotionTransformer
from motiondiffusion_moe_tpu_torch.tools import (
    bench_loader,
    profile_bench,
    serving_quality,
    soak_report,
    visualize,
)
from motiondiffusion_moe_tpu_torch.training.checkpoint import (
    CheckpointManager,
)
from motiondiffusion_moe_tpu_torch.training.train_state import (
    create_train_state,
)
from motiondiffusion_moe_tpu_torch.utils.profiling import trace

from tests._torch_parity import load_into, random_params, tiny_config, to_port
from tests.test_torch_eval import _save_finest_tar

TEXT, LENGTH, STEPS, SEED = "a person walks forward", 8, 3, 4


def _cfg():
    cfg = tiny_config(input_feats=263)
    return dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, dim_pose=263, num_joints=22))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(run dir, JAX config, flax params, normalizer mean, std)."""
    root = tmp_path_factory.mktemp("vis") / "run"
    cfg = _cfg()
    T, F = cfg.model.max_frames, cfg.model.input_feats
    ids = hash_tokenize([TEXT, ""], cfg.model.text_max_tokens)
    params = random_params(JaxMotionTransformer(cfg.model),
                           np.zeros((2, T, F), np.float32),
                           np.zeros(2, np.int32), np.full(2, T, np.int32),
                           text_ids=ids, seed=9)
    # a small head keeps the guided eps near the scale of real samples
    params["out"] = {k: 0.1 * v for k, v in params["out"].items()}
    port_cfg = to_port(cfg)
    os.makedirs(root)
    port_cfg.save(str(root / "config.json"))
    model = load_into(MotionTransformer(port_cfg.model), params)
    CheckpointManager(str(root / "ckpt")).save(
        0, create_train_state(model, port_cfg), epoch=0)
    # features of a motion's scale: joints within the plot's 4 m box, root
    # 1 m up (a motion far outside it draws the same empty frame each time)
    rng = np.random.default_rng(10)
    mean = (0.05 * rng.standard_normal(F)).astype(np.float32)
    mean[3] = 1.0
    std = (0.05 + 0.1 * rng.random(F)).astype(np.float32)
    MotionNormalizer(mean, std).save(str(root / "meta"))
    return str(root), cfg, params, mean, std


def _jax_joints(cfg, params, noise, mean, std):
    """JAX's DDIM (the pipeline's sampler, noise injected), then its
    normalizer, recover_from_ric and motion_temporal_filter."""
    model = JaxMotionTransformer(cfg.model)
    d = cfg.diffusion
    base = jax_make_schedule(schedule_name=d.beta_schedule,
                             num_timesteps=d.num_timesteps)
    sched, tmap = jax_respace(np.asarray(base.betas, np.float64),
                              jax_space(d.num_timesteps, f"ddim{STEPS}"))
    tok = cfg.model.text_max_tokens
    ids_c = jnp.asarray(hash_tokenize([TEXT], tok))
    ids_u = jnp.asarray(hash_tokenize([""], tok))
    length2 = jnp.asarray([LENGTH, LENGTH], jnp.int32)

    def fn(params, noise):
        v = {"params": params}
        enc_c = model.apply(v, ids_c, method=lambda m, i: m.encode_text(i))
        enc_u = model.apply(v, ids_u, method=lambda m, i: m.encode_text(i))
        xf_proj = jnp.concatenate([enc_c.pooled, enc_u.pooled])
        xf_out = jnp.concatenate([enc_c.tokens, enc_u.tokens])

        def model_doubled(x2, t2):
            return model.apply(v, x2, t2, length2, xf_proj=xf_proj,
                               xf_out=xf_out,
                               mutable=["moe_losses", "moe_metrics"])[0]

        return jax_ddim_loop(sched, model_doubled, noise, jax.random.key(0),
                             timestep_map=tmap, guidance_scale=d.cfg_scale)

    motion = np.asarray(jax.jit(fn)(params, jnp.asarray(noise)))[0, :LENGTH]
    motion = JaxMotionNormalizer(mean, std).denormalize_np(motion)
    joints = np.asarray(jax_recover_from_ric(jnp.asarray(motion),
                                             cfg.data.num_joints))
    return motion, jax_filter(joints, sigma=1.0)


def test_visualize_joints_match_jax_and_gif_frames(run, tmp_path, capsys):
    from PIL import Image, ImageSequence

    root, cfg, params, mean, std = run
    npy, gif = str(tmp_path / "j.npy"), str(tmp_path / "m.gif")
    joints = visualize.main([
        "--run_dir", root, "--text", TEXT, "--motion_length", str(LENGTH),
        "--sampler", "ddim", "--steps", str(STEPS), "--seed", str(SEED),
        "--npy_path", npy, "--result_path", gif, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "restored step 0" in out and "gif ->" in out
    saved = np.load(npy)
    np.testing.assert_array_equal(saved, joints)
    assert saved.shape == (LENGTH, 22, 3) and np.isfinite(saved).all()
    # the port's draw: the first F x T normals of the seeded generator
    T, F = cfg.model.max_frames, cfg.model.input_feats
    noise = torch.randn((1, T, F),
                        generator=torch.Generator().manual_seed(SEED)).numpy()
    _, ref = _jax_joints(cfg, params, noise, mean, std)
    np.testing.assert_allclose(saved, ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())
    with Image.open(gif) as im:  # 20 fps: 50 ms a frame
        assert im.n_frames == LENGTH
        assert [f.info["duration"] for f in ImageSequence.Iterator(im)] == [
            50] * LENGTH


def test_visualize_raises_without_a_card(run):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        visualize.main(["--run_dir", run[0], "--text", TEXT])


def test_serving_quality_end_to_end(run, tmp_path, monkeypatch, capsys):
    root = run[0]
    finest = str(tmp_path / "finest.tar")
    _save_finest_tar(finest)
    from motiondiffusion_moe_tpu_torch import pipeline as P

    placed = []
    set_params = P.GenerationPipeline.set_params
    monkeypatch.setattr(P.GenerationPipeline, "set_params",
                        lambda self, p: placed.append(self.param_dtype)
                        or set_params(self, p))
    result = serving_quality.main(["--run_dir", root, "--batch", "2",
                                   "--evaluator_ckpt", finest,
                                   "--device", "cpu"])
    out = capsys.readouterr().out
    assert "evaluator: finest.tar" in out and "bf16 drift dpm20" in out
    assert placed == [None, torch.bfloat16]  # once per dtype
    assert set(result["stats"]) == {"ddim50", "dpm20", "dpm10",
                                    "ddim50-bf16", "dpm20-bf16"}
    values = [v for pair in result["stats"].values() for v in pair] + list(
        result["drifts"].values())
    assert np.isfinite(values).all() and all(v >= 0 for v in values)
    # fewer steps, further from the full-schedule trajectory
    assert result["stats"]["dpm10"][0] > 0
    assert set(result["drifts"]) == {"ddim50", "dpm20"}
    assert "ddim100" in result["seconds"]


def _fake_log(path, rows):
    lines = []
    for ep, it, t, loss in rows:
        mm, ss = divmod(int(t), 60)
        lines.append(f"epoch: {ep:3d} niter: {it:07d} time: {mm}m {ss:02d}s "
                     f"grad_norm: 0.5 loss_moe: 0.30 loss_mot_rec: 1.0 "
                     f"loss_total: {loss:.4f}")
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_soak_report_equals_jax_and_reads_the_train_cli(tmp_path, capsys):
    h1 = _fake_log(tmp_path / "a.log", [(0, 10, 700, 1.33), (0, 160, 900, 1.2),
                                        (1, 320, 1100, 1.1),
                                        (1, 350, 1140, 1.08)])
    h2 = _fake_log(tmp_path / "b.log", [(1, 330, 30, 1.09), (2, 480, 230, 1.0),
                                        (2, 500, 260, 0.99)])
    ours, theirs = str(tmp_path / "o.json"), str(tmp_path / "t.json")
    soak_report.main(["--logs", h1, h2, "--out", ours])
    jax_soak.main(["--logs", h1, h2, "--out", theirs])
    with open(ours) as a, open(theirs) as b:
        assert json.load(a) == json.load(b)
    assert soak_report._LINE.pattern == jax_soak._LINE.pattern

    from motiondiffusion_moe_tpu_torch.tools.train import main as train_main

    capsys.readouterr()
    train_main(["--device", "cpu", "--batch_size", "4", "--num_epochs", "2",
                "--num_layers", "1", "--latent_dim", "32", "--ff_size", "16",
                "--num_heads", "2", "--num_experts", "4",
                "--text_latent_dim", "16", "--diffusion_steps", "50",
                "--no_uncond_step", "--dataset", "synthetic",
                "--synthetic_size", "8", "--log_every", "1",
                "--checkpoint_dir", str(tmp_path / "runs")])
    log = tmp_path / "train.log"
    log.write_text(capsys.readouterr().out)
    rows = soak_report.parse_log(str(log))
    printed = [line for line in log.read_text().splitlines()
               if "niter:" in line]
    assert len(rows) == len(printed) == 4
    assert [r["step"] for r in rows] == [1, 2, 3, 4]
    assert [r["epoch"] for r in rows] == [0, 0, 1, 1]
    assert all(np.isfinite(r["loss"]) for r in rows)
    assert soak_report.summarize([rows])["total_steps"] == 4


def test_profile_bench_analyze_cpu_trace(tmp_path):
    cfg = to_port(tiny_config(num_layers=1))
    from motiondiffusion_moe_tpu_torch.models.layers import init_weights

    model = init_weights(MotionTransformer(cfg.model), 0).eval()
    T, F = cfg.model.max_frames, cfg.model.input_feats
    ids = torch.from_numpy(hash_tokenize(["a person walks", ""],
                                         cfg.model.text_max_tokens))
    with trace(str(tmp_path)) as prof, torch.no_grad():
        model(torch.zeros(2, T, F), torch.tensor([5, 9]),
              torch.tensor([T, 4]), text_ids=ids)
    assert os.path.exists(prof.trace_path)
    out = profile_bench.analyze(str(tmp_path), 5, "cpu_op")
    assert out["total_ms"] > 0 and len(out["top"]) == 5
    fam_ms = sum(ms for _, ms in out["families"].values())
    assert abs(fam_ms - out["total_ms"]) <= 1e-6 * out["total_ms"]
    assert profile_bench.analyze(str(tmp_path), 5) is None  # no kernels


def test_profile_bench_families_on_kernel_events(tmp_path):
    names = {
        "void favor_kernel<true, 128, 128, 4, __nv_bfloat16>(Args)":
            "favor_qkv (1; 8, 10)",
        "void performer_epilogue_kernel<__nv_bfloat16, 512>(P)":
            "performer_epilogue (2)",
        "void favor_qkv_bwd_kernel<128>(A)": "favor_qkv_bwd (3)",
        "void performer_epilogue_bwd_kernel<512>(A)":
            "performer_epilogue_bwd (4)",
        "moe_bf16_kernel(Args)": "moe_dense_fused (5)",
        "void cross_attention_mma_kernel<AmShape>(L)":
            "cross-attention (6, 9; bf16)",
        "void adaln_bf16_kernel(A)": "adaln_dense (7)",
        "void activation_kernel<1>(A)": "activations (csrc/activations.cu)",
        "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64":
            "cuBLAS GEMM",
        "void at::native::elementwise_kernel<128, 2, add>(int, F)":
            "elementwise",
        "void at::native::reduce_kernel<512, 1>(R)": "reduction",
        "void at::native::direct_copy_kernel_cuda(T)": "copy",
        "void at::native::vectorized_layer_norm_kernel<float>(L)":
            "layer_norm",
        "void at::native::multi_tensor_apply_kernel<Adam>(T)":
            "optimizer (multi_tensor_apply)",
        "void at::native::radixSortKVInPlace<2, -1>(K)": "top-k / sort",
        "void something_else(int)": "other",
    }
    events = [{"ph": "X", "cat": "kernel", "name": n, "ts": i * 10.0,
               "dur": 2.0 + i, "pid": 0, "tid": 7}
              for i, n in enumerate(names)]
    events.append({"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0,
                   "dur": 1e6, "pid": 1, "tid": 1})
    with open(tmp_path / "trace.json", "w") as f:
        json.dump({"traceEvents": events}, f)
    out = profile_bench.analyze(str(tmp_path), 3)
    assert {profile_bench.family(n) for n in names} == set(names.values())
    assert out["total_ms"] == pytest.approx(sum(2.0 + i for i in range(
        len(names))) / 1e3)
    assert out["families"]["favor_qkv (1; 8, 10)"] == [1, 0.002]
    assert [k for k, _, _ in out["top"]] == list(names)[::-1][:3]


def test_profile_bench_raises_where_the_jax_tool_differs():
    with pytest.raises(NotImplementedError, match="steps_per_call"):
        profile_bench.capture(2, 2, "train", "unused", scan=2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            profile_bench.main(["--mode", "train"])


def test_bench_loader_on_a_small_corpus(capsys):
    result = bench_loader.main(["--items", "16", "--dim", "263", "--batch",
                                "4", "--epochs", "1", "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == result
    assert result["python_items_per_s"] > 0
    assert result["native_items_per_s"] > 0
    assert result["items"] == 16 and result["device"] == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench_loader.main(["--items", "4"])
