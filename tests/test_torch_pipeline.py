"""The whole sampling slice and the HTTP front end of the port, on the CPU.

The same flax weights (seeded numpy draws, every leaf nonzero) and the same
injected noise go through the JAX sampler, built as
``GenerationPipeline._sample_fn`` builds it, and through the port's
``GenerationPipeline.sample``: 3 steps of DDIM, DPM-Solver++ and DDPM (the
DDPM per-step noise injected too, from the JAX loop's own keys).

Tolerances: f32 compute -> max abs error 1e-5 x max|output|. The denoiser
outputs agree to ~1e-5 (tests/test_torch_models.py); guidance 7.5 and the
eps -> x0 factor sqrt(1/abar - 1) (up to ~1e2 near t = T-1 of the 100-step
schedule) carry random weights' samples to O(1e2), and the error with them.
bf16 compute -> relative RMS 3e-2, the denoiser's own bf16 agreement.
"""

import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motiondiffusion_moe_tpu.diffusion import (
    ddim_sample_loop as jax_ddim_loop,
    ddpm_sample_loop_cfg as jax_ddpm_loop_cfg,
    make_schedule as jax_make_schedule,
    respace_schedule as jax_respace,
    space_timesteps as jax_space,
)
from motiondiffusion_moe_tpu.diffusion.dpm_solver import (
    dpm_solver_pp_2m as jax_dpm,
)
from motiondiffusion_moe_tpu.models.transformer import (
    MotionTransformer as JaxMotionTransformer,
)
from motiondiffusion_moe_tpu_torch.data.normalizer import MotionNormalizer
from motiondiffusion_moe_tpu_torch.models.layers import init_weights
from motiondiffusion_moe_tpu_torch.models.text_encoder import hash_tokenize
from motiondiffusion_moe_tpu_torch.models.transformer import MotionTransformer
from motiondiffusion_moe_tpu_torch.ops import performer as P
from motiondiffusion_moe_tpu_torch.pipeline import GenerationPipeline
from motiondiffusion_moe_tpu_torch.tools.serve import make_server

from tests._torch_parity import load_into, random_params, rel_rms, tiny_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MB = 3  # micro-batch
STEPS = 3
PROMPTS = ["a person walks forward", "jump", ""]
LENGTHS = [16, 9, 1]


@pytest.fixture(scope="module")
def flax_params():
    cfg = tiny_config(num_layers=1)
    T, F = cfg.model.max_frames, cfg.model.input_feats
    x = np.zeros((MB, T, F), np.float32)
    ids = hash_tokenize(PROMPTS, cfg.model.text_max_tokens)
    params = random_params(JaxMotionTransformer(cfg.model), x,
                           np.zeros(MB, np.int32), np.full(MB, T, np.int32),
                           text_ids=ids)
    # a head 10x smaller than the draw (the trained head is small; it is
    # zero at init) keeps the guided eps near the scale of real samples
    params["out"] = {k: 0.1 * v for k, v in params["out"].items()}
    return params


def _jax_sample(cfg, params, sampler, noise, loop_key):
    """The JAX sampler as ``pipeline.py:192-226`` builds it, with the
    initial noise injected; returns (motions, the sampler's schedule)."""
    model = JaxMotionTransformer(cfg.model)
    variables = {"params": params}
    d = cfg.diffusion
    base = jax_make_schedule(schedule_name=d.beta_schedule,
                             num_timesteps=d.num_timesteps)
    sched, tmap = base, None
    if sampler != "dpm":
        sched, tmap = jax_respace(np.asarray(base.betas, np.float64),
                                  jax_space(d.num_timesteps,
                                            f"ddim{STEPS}"))
    tok = cfg.model.text_max_tokens
    ids_c = jnp.asarray(hash_tokenize(PROMPTS, tok))
    ids_u = jnp.asarray(hash_tokenize([""] * MB, tok))
    lengths = jnp.asarray(LENGTHS, jnp.int32)

    def fn(params, noise, key):
        enc_c = model.apply(params, ids_c, method=lambda m, i: m.encode_text(i))
        enc_u = model.apply(params, ids_u, method=lambda m, i: m.encode_text(i))
        xf_proj = jnp.concatenate([enc_c.pooled, enc_u.pooled])
        xf_out = jnp.concatenate([enc_c.tokens, enc_u.tokens])
        length2 = jnp.concatenate([lengths, lengths])

        def model_doubled(x2, t2):
            return model.apply(params, x2, t2, length2, xf_proj=xf_proj,
                               xf_out=xf_out,
                               mutable=["moe_losses", "moe_metrics"])[0]

        kw = dict(guidance_scale=d.cfg_scale)
        if sampler == "dpm":
            return jax_dpm(sched, model_doubled, noise, num_steps=STEPS, **kw)
        if sampler == "ddim":
            return jax_ddim_loop(sched, model_doubled, noise, key,
                                 timestep_map=tmap, **kw)
        return jax_ddpm_loop_cfg(sched, model_doubled, noise, key,
                                 timestep_map=tmap, **kw)

    out = jax.jit(fn)(variables, jnp.asarray(noise), loop_key)
    return np.asarray(out), sched


def _port_pipeline(cfg, params, sampler, **kw):
    model = load_into(MotionTransformer(cfg.model), params)
    return GenerationPipeline(cfg, model, sampler=sampler,
                              num_inference_steps=STEPS, micro_batch=MB, **kw)


def _port_sample(pipe, noise, step_noise=None):
    tok = pipe.cfg.model.text_max_tokens
    out = pipe.sample(torch.from_numpy(hash_tokenize(PROMPTS, tok)),
                      torch.from_numpy(hash_tokenize([""] * MB, tok)),
                      torch.tensor(LENGTHS), noise=torch.from_numpy(noise),
                      step_noise=step_noise)
    return out.numpy()


def _slice_both(dtype, sampler, params):
    cfg = tiny_config(dtype, num_layers=1)
    T, F = cfg.model.max_frames, cfg.model.input_feats
    noise = np.random.default_rng(5).standard_normal((MB, T, F)).astype(
        np.float32)
    key = jax.random.key(11)
    ref, _ = _jax_sample(cfg, params, sampler, noise, key)
    step_noise = None
    if sampler == "ddpm":  # the JAX loop's z_i = normal(split(key, n)[i])
        step_noise = [torch.from_numpy(np.array(
            jax.random.normal(k, noise.shape)))
            for k in jax.random.split(key, STEPS)]
    pipe = _port_pipeline(cfg, params, sampler)
    assert pipe.sched.num_timesteps == (100 if sampler == "dpm" else STEPS)
    out = _port_sample(pipe, noise, step_noise)
    assert out.shape == (MB, T, F) and np.isfinite(out).all()
    return out, ref


@pytest.mark.parametrize("sampler", ["ddim", "dpm", "ddpm"])
def test_slice_matches_jax_f32(sampler, flax_params):
    out, ref = _slice_both("float32", sampler, flax_params)
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()


def test_slice_matches_jax_bf16(flax_params):
    out, ref = _slice_both("bfloat16", "dpm", flax_params)
    assert rel_rms(out, ref) < 3e-2


# ---------------------------------------------------------------- pipeline

@pytest.fixture(scope="module")
def seeded_pipe():
    cfg = tiny_config(num_layers=1)
    model = init_weights(MotionTransformer(cfg.model), 0)
    with torch.no_grad():  # or the zero-init head returns exactly zero
        model.out.weight.normal_(0.0, 0.05,
                                 generator=torch.Generator().manual_seed(1))
    pipe = GenerationPipeline(cfg, model, sampler="dpm",
                              num_inference_steps=2, micro_batch=2,
                              param_dtype="bfloat16")
    pipe.normalizer = MotionNormalizer.identity(cfg.data.dim_pose)
    return pipe


def test_bf16_params_keep_the_projection_f32(seeded_pipe):
    dtypes = {n: p.dtype for n, p in seeded_pipe.model.named_parameters()}
    proj = [n for n in dtypes if "projection" in n]
    assert proj and all(dtypes[n] == torch.float32 for n in proj)
    assert all(d == torch.bfloat16 for n, d in dtypes.items()
               if "projection" not in n)


def test_generate_pads_chunks_and_crops(seeded_pipe):
    calls = []
    sample = seeded_pipe.sample

    def counted(ids_c, *a, **k):
        calls.append(ids_c.shape[0])
        return sample(ids_c, *a, **k)

    seeded_pipe.sample = counted
    try:
        out = seeded_pipe.generate(["walk", "run", "sit"], [16, 3, 7],
                                   generator=torch.Generator().manual_seed(0))
    finally:
        seeded_pipe.sample = sample
    assert calls == [2, 2]  # two micro-batches, the tail padded
    assert [o.shape for o in out] == [(16, 26), (3, 26), (7, 26)]
    assert all(np.isfinite(o).all() and o.dtype == np.float32 for o in out)
    assert seeded_pipe.forwards_per_sample == 3


def test_generate_is_a_function_of_the_generator(seeded_pipe):
    def run(seed):
        return seeded_pipe.generate(
            ["walk", "run"], [16, 8],
            generator=torch.Generator().manual_seed(seed))

    a, b, c = run(3), run(3), run(4)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])


def test_generate_rejects_bad_inputs(seeded_pipe):
    with pytest.raises(ValueError, match="outside"):
        seeded_pipe.generate(["a"], [17])
    with pytest.raises(ValueError, match="captions"):
        seeded_pipe.generate(["a", "b"], [4])
    with pytest.raises(ValueError):
        GenerationPipeline(tiny_config(), seeded_pipe.model, sampler="euler")


# ---------------------------------------------------------------- serving

def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_make_server_answers_healthz_and_generate(seeded_pipe):
    srv = make_server(seeded_pipe, port=0, max_batch=4)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["ok"] is True and health["sampler"] == "dpm"
        assert health["device"] == "cpu"
        status, body = _post(url + "/generate",
                             {"texts": ["a person waves"], "lengths": [12]})
        assert status == 200 and body["shapes"] == [[12, 26]]
        assert np.isfinite(np.asarray(body["motions"])).all()
        seeded = {"texts": ["bow", "kick"], "lengths": [5, 16], "seed": 9}
        s1, b1 = _post(url + "/generate", seeded)
        s2, b2 = _post(url + "/generate", seeded)
        assert s1 == s2 == 200 and b1["motions"] == b2["motions"]
        assert _post(url + "/generate", {"texts": ["x"],
                                         "lengths": [99]})[0] == 400
        assert _post(url + "/generate", {"texts": ["x"] * 5,
                                         "lengths": [4] * 5})[0] == 400
    finally:
        srv.shutdown()
        srv.server_close()
    # CPU tensors never launch a kernel
    assert P.favor_qkv.launches == 0 and P.performer_epilogue.launches == 0


def test_port_never_imports_jax_or_flax():
    """Import the port and run a tiny generate in a fresh interpreter."""
    code = """
import sys
import torch
from motiondiffusion_moe_tpu.config import (DataConfig, DiffusionConfig,
                                            ExperimentConfig, ModelConfig)
import motiondiffusion_moe_tpu_torch.tools.serve
import motiondiffusion_moe_tpu_torch.models.bridge
import motiondiffusion_moe_tpu_torch.motion.recover
import motiondiffusion_moe_tpu_torch.ops._build
from motiondiffusion_moe_tpu_torch.models.layers import init_weights
from motiondiffusion_moe_tpu_torch.models.transformer import MotionTransformer
from motiondiffusion_moe_tpu_torch.pipeline import GenerationPipeline
cfg = ExperimentConfig(
    data=DataConfig(dim_pose=26, max_motion_length=8, num_joints=4),
    diffusion=DiffusionConfig(num_timesteps=100),
    model=ModelConfig(input_feats=26, max_frames=8, latent_dim=32, ff_size=16,
                      num_layers=1, num_heads=2, num_experts=2,
                      text_latent_dim=8, num_random_features=16,
                      text_max_tokens=6))
pipe = GenerationPipeline(cfg, init_weights(MotionTransformer(cfg.model), 0),
                          sampler="ddim", num_inference_steps=2, micro_batch=1)
assert pipe.generate(["walk"], [5])[0].shape == (5, 26)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax"))
print("LOADED", bad)
sys.exit(1 if bad else 0)
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout
