"""The serving slice of the port against the JAX package, on the CPU: the
flax-msgpack codec, the bridge in both directions, the export in both
directions, ``GenerationPipeline.from_export`` / ``fetch_window`` and the
serve command line.

The widths are ``tests/test_export.py``'s (latent 32, 2 heads, 8 random
features, one block per scale), with 100 diffusion steps. The JAX runs are
built once per module. Sampling: the same weights (read from one export by
each package) and injected noise go through the JAX sampler, built as
``pipeline.py:192-226`` builds it, and through the port's
``GenerationPipeline.sample``: 3 steps of DDIM and DPM-Solver++ in f32
compute. Tolerance: max abs error 1e-5 x max|output|, as
``tests/test_torch_pipeline.py``; at both storage dtypes, because the
weights' values are identical and the arithmetic is f32 (bf16 weights are
widened exactly in both packages).
"""

import json
import os
import threading
import urllib.request

import flax.serialization as fser
import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from motiondiffusion_moe_tpu.config import (
    DataConfig,
    DiffusionConfig,
    ExperimentConfig,
    ModelConfig,
    TrainConfig,
)
from motiondiffusion_moe_tpu.data import MotionNormalizer as JaxNormalizer
from motiondiffusion_moe_tpu.tools.export import (
    export_run as jax_export_run,
    load_export as jax_load_export,
)
from motiondiffusion_moe_tpu.training import (
    CheckpointManager as JaxCheckpointManager,
    Trainer as JaxTrainer,
)
from motiondiffusion_moe_tpu_torch.data.normalizer import MotionNormalizer
from motiondiffusion_moe_tpu_torch.models.bridge import (
    jax_to_state_dict,
    state_dict_to_jax,
)
from motiondiffusion_moe_tpu_torch.models.layers import init_weights
from motiondiffusion_moe_tpu_torch.models.transformer import MotionTransformer
from motiondiffusion_moe_tpu_torch.pipeline import GenerationPipeline
from motiondiffusion_moe_tpu_torch.tools import export as port_export
from motiondiffusion_moe_tpu_torch.tools.serve import (
    build_argparser,
    build_server,
)
from motiondiffusion_moe_tpu_torch.training.checkpoint import (
    CheckpointManager,
)
from motiondiffusion_moe_tpu_torch.training.trainer import Trainer
from motiondiffusion_moe_tpu_torch.utils import flax_msgpack

from tests._torch_parity import perturb_zero_leaves, to_port
from tests.test_torch_pipeline import MB, STEPS, _jax_sample, _port_sample

F = 26


def _tiny_cfg(**train_kw) -> ExperimentConfig:
    return ExperimentConfig(
        name="exp",
        data=DataConfig(dim_pose=F, max_motion_length=16,
                        min_motion_length=8, num_joints=4),
        diffusion=DiffusionConfig(num_timesteps=100),
        model=ModelConfig(input_feats=F, max_frames=16, latent_dim=32,
                          ff_size=16, num_layers=1, num_heads=2,
                          num_experts=4, text_latent_dim=16,
                          num_random_features=8, text_max_tokens=8,
                          dropout=0.0, stochastic_depth_min=1.0,
                          dtype="float32"),
        train=TrainConfig(batch_size=4, uncond_step=False, **train_kw),
    )


def _normalizer(cls):
    return cls(np.full(F, 0.5, np.float32), np.full(F, 2.0, np.float32))


def _bits(x) -> np.ndarray:
    """A leaf's bits: bf16 (torch or JAX's numpy dtype) as int16 words."""
    if flax_msgpack.is_bf16(x):
        return flax_msgpack.bf16_words(x)
    if isinstance(x, torch.Tensor):
        x = x.detach().numpy()
    return np.asarray(x)


def _same_leaf(a, b) -> bool:
    name = lambda x: "bfloat16" if flax_msgpack.is_bf16(x) else str(  # noqa
        np.asarray(x).dtype)
    return (name(a) == name(b) and tuple(a.shape) == tuple(b.shape)
            and np.array_equal(_bits(a), _bits(b)))


def _leaves(tree) -> dict:
    return {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=lambda x: isinstance(x, torch.Tensor))}


def _noise(seed=5):
    return np.random.default_rng(seed).standard_normal(
        (MB, 16, F)).astype(np.float32)


# ---------------------------------------------------------------- fixtures

@pytest.fixture(scope="module")
def jax_exports(tmp_path_factory):
    """A JAX run dir (nonzero weights in its checkpoint) and its exports at
    f32 and bf16 storage, both by the JAX package's ``export_run``."""
    tmp = tmp_path_factory.mktemp("jax")
    cfg = _tiny_cfg()
    run = str(tmp / cfg.name)
    os.makedirs(run)
    cfg.save(os.path.join(run, "config.json"))
    state = JaxTrainer(cfg).init_state()
    init = jax.device_get(state.params["params"])
    state = state.replace(params=perturb_zero_leaves(state.params, seed=1))
    ckpt = JaxCheckpointManager(os.path.join(run, "ckpt"))
    ckpt.save(0, state, epoch=0, rng=jax.random.key(3))
    ckpt.wait()
    _normalizer(JaxNormalizer).save(os.path.join(run, "meta"))
    return {"cfg": cfg, "init": init,
            "float32": jax_export_run(run, str(tmp / "f32")),
            "bfloat16": jax_export_run(run, str(tmp / "bf16"),
                                       dtype="bfloat16")}


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """A run dir of the port (``Trainer`` + ``CheckpointManager``), with an
    EMA that differs from the weights, and one without an EMA."""
    runs = {}
    for name, ema in (("ema", 0.99), ("plain", 0.0)):
        cfg = to_port(_tiny_cfg(ema_decay=ema))
        run = str(tmp_path_factory.mktemp("port") / name)
        os.makedirs(run)
        cfg.save(os.path.join(run, "config.json"))
        state = Trainer(cfg, device="cpu").init_state()
        g = torch.Generator().manual_seed(2)
        with torch.no_grad():
            for p in state.model.parameters():
                if not p.any():
                    p.normal_(0.0, 0.05, generator=g)
            if state.ema is not None:
                for e, p in zip(state.ema.params, state.model.parameters()):
                    e.copy_(p + 0.01 * torch.randn(p.shape, generator=g))
        state.step = 7
        CheckpointManager(os.path.join(run, "ckpt")).save(7, state, epoch=1)
        _normalizer(MotionNormalizer).save(os.path.join(run, "meta"))
        runs[name] = (run, cfg, state)
    return runs


# ---------------------------------------------------------------- codec

def _codec_tree():
    rng = np.random.default_rng(0)
    return {
        "params": {
            "dense": {"kernel": rng.standard_normal((3, 5)).astype(
                np.float32), "bias": rng.standard_normal(5).astype(
                    np.float32)},
            "half": rng.standard_normal((4, 3)).astype(ml_dtypes.bfloat16),
            "count": np.arange(7, dtype=np.int32),
            "empty": np.zeros((0, 2), np.float32),
            "scalars": {"f": np.float32(1.25), "i": np.int32(-7),
                        "b": np.bool_(True),
                        "h": ml_dtypes.bfloat16(0.375)},
            # 200 bytes: chunked when MAX_CHUNK_SIZE is 64
            "big": rng.standard_normal(50).astype(np.float32),
            "bigh": rng.standard_normal(70).astype(ml_dtypes.bfloat16),
        },
        "step": 70000, "neg": -200, "name": "x" * 40, "flag": False,
        "none": None, "lr": 0.5, "raw": b"\x00\x01" * 200,
        "items": [1, 2.5, "a"],
    }


@pytest.fixture(params=[False, True], ids=["whole", "chunked"])
def chunk_size(request, monkeypatch):
    """flax's and the port's MAX_CHUNK_SIZE, small where asked, so that
    the 'big' leaves are written in flax's chunked form."""
    size = 64 if request.param else flax_msgpack.MAX_CHUNK_SIZE
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", size)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", size)
    return size


def test_codec_reads_flax_bytes_bit_exact(chunk_size):
    tree = _codec_tree()
    data = fser.msgpack_serialize(tree)
    if chunk_size == 64:
        assert data.count(flax_msgpack.CHUNKED_KEY.encode()) == 2
    got = flax_msgpack.msgpack_restore(data)
    want, have = _leaves(tree), _leaves(got)
    assert want.keys() == have.keys()
    for k, v in want.items():
        if isinstance(v, (np.ndarray, np.generic)):
            assert _same_leaf(have[k], v), k
            assert isinstance(have[k], torch.Tensor if
                              flax_msgpack.is_bf16(v) else type(v)), k
        else:
            assert type(have[k]) is type(v) and have[k] == v, k
    assert got["none"] is None and got["items"] == [1, 2.5, "a"]
    assert got["params"]["half"].dtype == torch.bfloat16


def test_flax_reads_the_ports_bytes(chunk_size):
    tree = _codec_tree()
    # the port's writer also takes torch tensors: a bf16 one, an f32 one
    tree["params"]["torch_half"] = torch.tensor([1.5, -2.25, 3.0e-3],
                                                dtype=torch.bfloat16)
    tree["params"]["torch_f32"] = torch.arange(6.0).reshape(2, 3)
    got = fser.msgpack_restore(flax_msgpack.msgpack_serialize(tree))
    want, have = _leaves(tree), _leaves(got)
    assert want.keys() == have.keys()
    for k, v in want.items():
        if isinstance(v, (np.ndarray, np.generic, torch.Tensor)):
            assert _same_leaf(have[k], v), k
        else:
            assert have[k] == v, k
    assert got["params"]["torch_half"].dtype == ml_dtypes.bfloat16


def test_both_writers_give_the_same_bytes(chunk_size):
    tree = _codec_tree()
    assert flax_msgpack.msgpack_serialize(tree) == fser.msgpack_serialize(
        tree)


def test_codec_rejects_what_flax_rejects():
    with pytest.raises(TypeError):
        flax_msgpack.msgpack_serialize({"t": (1, 2)})
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.msgpack_restore(fser.msgpack_serialize(
            {"a": np.ones(4, np.float32)})[:-3])


# ---------------------------------------------------------------- bridge

def _port_model(cfg, seed=0):
    return init_weights(MotionTransformer(to_port(cfg).model), seed)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_state_dict_round_trips_through_the_flax_tree(dtype):
    cfg = _tiny_cfg()
    sd = port_export.cast_serving_dtype(_port_model(cfg).state_dict(), dtype)
    back = jax_to_state_dict(state_dict_to_jax(sd, to_port(cfg)))
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
    assert (back["out.weight"].dtype == torch.bfloat16) == (dtype ==
                                                           "bfloat16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_init_tree_round_trips_through_the_state_dict(jax_exports,
                                                         dtype):
    """The JAX model's init tree (the JAX Trainer's) -> state_dict -> tree:
    the same paths, shapes, dtypes and bits."""
    tree = jax_exports["init"]
    if dtype == "bfloat16":  # the JAX export's leaf rule
        from motiondiffusion_moe_tpu.tools.export import cast_serving_dtype
        tree = cast_serving_dtype(tree, dtype)
    back = state_dict_to_jax(jax_to_state_dict(tree),
                             to_port(jax_exports["cfg"]))
    want, have = _leaves(tree), _leaves(back)
    assert want.keys() == have.keys() and len(want) > 200
    assert any(flax_msgpack.is_bf16(v) for v in want.values()) == (
        dtype == "bfloat16")
    for k, v in want.items():
        assert _same_leaf(have[k], v), k


# ---------------------------------------------------------------- JAX -> port

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_from_export_stores_each_leaf_as_the_jax_pipeline(jax_exports,
                                                          dtype):
    d = jax_exports[dtype]
    _, params, _ = jax_load_export(d)
    pipe = GenerationPipeline.from_export(d, micro_batch=MB, device="cpu")
    assert pipe.normalizer.std[0] == 2.0 and pipe.normalizer.mean[0] == 0.5
    want = jax_to_state_dict(params)
    seen = set()
    for name, p in pipe.model.named_parameters():
        leaf = want[name]
        assert p.dtype == leaf.dtype and torch.equal(p, leaf), name
        seen.add(str(p.dtype))
    bf16 = dtype == "bfloat16"
    assert seen == ({"torch.bfloat16", "torch.float32"} if bf16
                    else {"torch.float32"})
    for name, p in pipe.model.named_parameters():
        assert (p.dtype == torch.bfloat16) == (bf16 and "projection" not in
                                               name), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sampler", ["ddim", "dpm"])
def test_port_samples_a_jax_export_as_jax_does(jax_exports, dtype, sampler):
    """f32 compute on bf16-stored weights: flax widens them to f32 before
    each product; the port must not compute in bf16 there."""
    d = jax_exports[dtype]
    cfg, params, _ = jax_load_export(d)
    noise = _noise()
    ref, _ = _jax_sample(cfg, params["params"], sampler, noise,
                         jax.random.key(11))
    pipe = GenerationPipeline.from_export(d, sampler=sampler,
                                          num_inference_steps=STEPS,
                                          micro_batch=MB, device="cpu")
    out = _port_sample(pipe, noise)
    assert out.shape == ref.shape and np.isfinite(out).all()
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()


def test_bf16_storage_changes_the_sample(jax_exports):
    """The bf16 export is a different model from the f32 one (the check
    above would pass vacuously if the port widened nothing)."""
    outs = []
    for dtype in ("float32", "bfloat16"):
        pipe = GenerationPipeline.from_export(
            jax_exports[dtype], sampler="dpm", num_inference_steps=STEPS,
            micro_batch=MB, device="cpu")
        outs.append(_port_sample(pipe, _noise()))
    assert not np.array_equal(outs[0], outs[1])


# ---------------------------------------------------------------- port -> JAX

@pytest.mark.parametrize("use_ema", [False, True])
def test_jax_reads_the_ports_export(port_run, tmp_path, use_ema):
    run, cfg, state = port_run["ema"]
    out = port_export.export_run(run, str(tmp_path / "out"),
                                 use_ema=use_ema)
    assert sorted(os.listdir(out)) == ["config.json", "export.json", "meta",
                                       "params.msgpack"]
    with open(os.path.join(out, "export.json")) as f:
        assert json.load(f) == {"step": 7, "use_ema": use_ema,
                                "dtype": "float32"}
    jcfg, params, norm = jax_load_export(out)
    assert jcfg == _tiny_cfg(ema_decay=0.99)
    assert norm.std[0] == 2.0
    names = [n for n, _ in state.model.named_parameters()]
    weights = (dict(zip(names, state.ema.params)) if use_ema
               else state.model.state_dict())
    got = jax_to_state_dict(params)
    assert got.keys() == weights.keys()
    for k, v in weights.items():
        assert torch.equal(got[k], v), k
    # the JAX sampler on what JAX read, the port's on what the port reads
    noise = _noise(6)
    ref, _ = _jax_sample(jcfg, params["params"], "dpm", noise,
                         jax.random.key(0))
    pipe = GenerationPipeline.from_export(out, sampler="dpm",
                                          num_inference_steps=STEPS,
                                          micro_batch=MB, device="cpu")
    res = _port_sample(pipe, noise)
    assert np.abs(res - ref).max() <= 1e-5 * np.abs(ref).max()


def test_ports_bf16_export_is_the_jax_exports_leaf_rule(port_run, tmp_path):
    run, _, state = port_run["plain"]
    out = port_export.export_run(run, str(tmp_path / "bf"),
                                 dtype="bfloat16")
    _, params, _ = jax_load_export(out)
    for k, v in _leaves(params).items():
        want = "float32" if "projection" in k else "bfloat16"
        assert str(v.dtype) == want, k
    got = jax_to_state_dict(params)
    for k, v in state.model.state_dict().items():
        assert torch.equal(got[k], v if "projection" in k
                           else v.to(torch.bfloat16)), k


def test_export_without_ema_raises_for_use_ema(port_run, tmp_path):
    run, _, _ = port_run["plain"]
    with pytest.raises(ValueError, match="no EMA"):
        port_export.export_run(run, str(tmp_path / "e"), use_ema=True)
    with pytest.raises(FileNotFoundError):
        port_export.export_run(str(tmp_path), str(tmp_path / "e"))


def test_export_main_takes_the_jax_clis_flags(port_run, tmp_path):
    run, _, _ = port_run["ema"]
    out = str(tmp_path / "cli")
    port_export.main(["--run_dir", run, "--out", out, "--use_ema",
                      "--step", "7", "--dtype", "bfloat16"])
    with open(os.path.join(out, "export.json")) as f:
        assert json.load(f) == {"step": 7, "use_ema": True,
                                "dtype": "bfloat16"}


# ---------------------------------------------------------------- pipeline

def test_fetch_window_keeps_the_outputs(jax_exports):
    prompts = ["walk", "run", "jump", "", "sit", "wave", "kick"]
    lens = [16, 3, 9, 1, 12, 16, 5]
    outs = []
    for window in (1, 2, 3):
        pipe = GenerationPipeline.from_export(
            jax_exports["float32"], sampler="dpm", num_inference_steps=2,
            micro_batch=2, fetch_window=window, device="cpu")
        assert pipe.fetch_window == window
        outs.append(pipe.generate(
            prompts, lens, generator=torch.Generator().manual_seed(4)))
    assert [o.shape for o in outs[0]] == [(n, F) for n in lens]
    for other in outs[1:]:
        assert all(np.array_equal(a, b) for a, b in zip(outs[0], other))


def test_set_params_takes_a_tree_or_a_state_dict(jax_exports):
    _, params, _ = jax_load_export(jax_exports["float32"])
    a = GenerationPipeline.from_export(jax_exports["float32"],
                                       param_dtype="bfloat16", device="cpu")
    b = GenerationPipeline(to_port(jax_exports["cfg"]),
                           params=jax_to_state_dict(params),
                           param_dtype="bfloat16", device="cpu")
    for (n, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        want = torch.float32 if "projection" in n else torch.bfloat16
        assert p.dtype == q.dtype == want and torch.equal(p, q), n
    with pytest.raises(ValueError, match="a model .*, or params"):
        GenerationPipeline(to_port(jax_exports["cfg"]), device="cpu")


# ---------------------------------------------------------------- serve CLI

def _get(url):
    with urllib.request.urlopen(url, timeout=120) as r:
        return json.loads(r.read())


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _serve(argv):
    srv = build_server(argv + ["--device", "cpu", "--port", "0",
                               "--sampler", "dpm", "--steps", "2",
                               "--micro_batch", "2"])
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.mark.parametrize("source", ["export_dir", "run_dir"])
def test_serve_cli_answers(jax_exports, port_run, source):
    argv = (["--export_dir", jax_exports["float32"]] if source == "export_dir"
            else ["--run_dir", port_run["ema"][0], "--use_ema"])
    srv, url = _serve(argv)
    try:
        health = _get(url + "/healthz")
        assert health["ok"] is True and health["device"] == "cpu"
        assert health["sampler"] == "dpm" and health["micro_batch"] == 2
        body = _post(url + "/generate", {"texts": ["a person waves"],
                                         "lengths": [12]})
        assert body["shapes"] == [[12, F]]
        seeded = {"texts": ["bow", "kick"], "lengths": [5, 16], "seed": 9}
        b1, b2 = (_post(url + "/generate", seeded) for _ in range(2))
        assert b1["motions"] == b2["motions"]
        raw = _post(url + "/generate", {**seeded, "denormalize": False})
        for m, r in zip(b1["motions"], raw["motions"]):
            np.testing.assert_allclose(np.asarray(m),
                                       np.asarray(r) * 2.0 + 0.5, rtol=1e-6)
    finally:
        srv.shutdown()
        srv.server_close()


def test_serve_cli_runs_on_the_card_unless_asked(jax_exports):
    assert build_argparser().parse_args(
        ["--export_dir", "x"]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_server(["--export_dir", jax_exports["float32"]])


@pytest.mark.parametrize("flag", ["--data_parallel", "--expert_parallel",
                                  "--tensor_parallel"])
def test_serve_cli_multi_device_flags_raise(jax_exports, flag):
    """In one process a degree above 1 raises: one process per device."""
    with pytest.raises(ValueError, match="one process per device"):
        build_server(["--export_dir", jax_exports["float32"], flag, "2",
                      "--device", "cpu"])
