"""A JAX run's orbax checkpoints read, resumed and written by the port, on
the CPU.

The layers, bottom up: ``utils/zstd.py`` against ``zstandard``;
``utils/ocdbt.py`` against tensorstore's OCDBT driver (keys and values,
byte for byte); ``utils/orbax_format.py`` against the JAX package's
``CheckpointManager.restore_with_rng`` (every leaf, bit for bit, bf16
included) and, for the layout the port writes, the JAX package restoring
it; ``training/checkpoint.py`` and the entry points on top (``load_run``,
``export``, ``serve``, ``evaluate``, ``visualize``, ``tools/train.py``).

The runs:

- ``chain``: the flags of both ``tools/train.py`` CLIs at a tiny width
  (latent 32, one block per scale, EMA, warmup, bf16 ``mu``). A JAX state
  with nonzero moments is saved at step 3 by the JAX ``CheckpointManager``
  (OCDBT, with the key); the port's ``tools/train.py`` resumes it for one
  step and saves step 4 in the JAX layout; the JAX ``tools/train.py``
  resumes that for one step and saves step 5 (OCDBT again).
- ``variants``: steps of one tiny model (F 26, T 16) that the JAX
  ``CheckpointManager`` saves from JAX ``TrainState``s built with the JAX
  package's ``make_optimizer``: EMA on and off, ``mu`` bf16 or both moments
  bf16 (``scale_by_adam_compact``), constant, warmup and cosine learning
  rates, the key saved or not. Their moments are seeded draws (zero for the
  sown collections and the frozen FAVOR+ projections, as training leaves
  them).
- the committed fixture ``tests/fixtures/jax_orbax_run/`` and its ``.npz``
  (``tests/make_orbax_fixture.py``).

Tolerances: the forward as ``tests/test_torch_models.py`` holds the whole
denoiser (atol 1e-4); the resumed step as ``tests/test_torch_train_step.py``
holds one (loss rtol 1e-5; each gradient within 1e-4 of its largest entry
plus 1e-7; the parameters within 2e-6 where |g| >= 1e-6 and 2 lr
everywhere), the moments within what that gradient bound moves them
((1 - b1) and (1 - b2) times it) plus 1e-6 of their size. Everything else
is exact.
"""

import dataclasses
import io
import json
import os
import shutil
from contextlib import redirect_stdout

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import tensorstore as ts
import torch
import zstandard

from motiondiffusion_moe_tpu.diffusion import gaussian as JG
from motiondiffusion_moe_tpu.models.transformer import (
    MotionTransformer as JaxMotionTransformer,
    generate_src_mask as jax_src_mask,
    sum_moe_aux_losses as jax_sum_aux,
)
from motiondiffusion_moe_tpu.tools.export import (
    export_run as jax_export_run,
)
from motiondiffusion_moe_tpu.tools.train import (
    build_argparser as jax_train_args,
    config_from_args as jax_config_from_args,
    main as jax_train_main,
)
from motiondiffusion_moe_tpu.training import (
    CheckpointManager as JaxCheckpointManager,
    Trainer as JaxTrainer,
)
from motiondiffusion_moe_tpu.training import losses as JL
from motiondiffusion_moe_tpu.training.train_state import (
    TrainState as JaxTrainState,
    make_optimizer,
)
from motiondiffusion_moe_tpu_torch.diffusion.gaussian import make_schedule
from motiondiffusion_moe_tpu_torch.models.bridge import jax_to_state_dict
from motiondiffusion_moe_tpu_torch.models.text_encoder import hash_tokenize
from motiondiffusion_moe_tpu_torch.models.transformer import (
    MotionTransformer,
)
from motiondiffusion_moe_tpu_torch.tools import export as port_export
from motiondiffusion_moe_tpu_torch.tools.train import main as port_train_main
from motiondiffusion_moe_tpu_torch.training.checkpoint import (
    CheckpointManager,
    resume_seed,
)
from motiondiffusion_moe_tpu_torch.training.train_state import (
    TrainStep,
    create_train_state,
)
from motiondiffusion_moe_tpu_torch.training.trainer import Trainer
from motiondiffusion_moe_tpu_torch.utils import ocdbt, orbax_format, zstd
from motiondiffusion_moe_tpu_torch.utils.orbax_format import (
    flatten,
    read_step,
    write_step,
)

from tests._torch_parity import perturb_zero_leaves, t, tiny_config, to_port

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
FIXTURE_RUN = os.path.join(FIXTURES, "jax_orbax_run")
CHAIN_FLAGS = ["--name", "chain", "--dataset", "synthetic",
               "--synthetic_size", "4", "--batch_size", "4",
               "--num_layers", "1", "--latent_dim", "32", "--ff_size", "16",
               "--num_heads", "2", "--num_experts", "4",
               "--text_latent_dim", "16", "--diffusion_steps", "100",
               "--no_uncond_step", "--save_latest", "1", "--ema_decay",
               "0.9", "--lr_warmup_steps", "5", "--adam_mu_dtype",
               "bfloat16"]
# name -> (train config, whether the key is saved)
VARIANTS = {
    "warmup_mu_bf16_ema_key": (dict(lr_warmup_steps=5,
                                    adam_mu_dtype="bfloat16",
                                    ema_decay=0.9), True),
    "cosine_compact_noema_nokey": (dict(lr_schedule="cosine",
                                        lr_warmup_steps=2,
                                        lr_decay_steps=50,
                                        adam_mu_dtype="bfloat16",
                                        adam_nu_dtype="bfloat16"), False),
    "warmup_f32_ema_key": (dict(lr_warmup_steps=5, ema_decay=0.9), True),
    "constant_f32_noema_nokey": (dict(), False),
}
B1, B2 = 0.9, 0.999


# ---------------------------------------------------------------- helpers

def _dotted(path) -> str:
    parts = []
    for k in path:
        for attr in ("key", "idx", "name"):
            if hasattr(k, attr):
                parts.append(str(getattr(k, attr)))
                break
    return ".".join(parts)


def _bits(x) -> np.ndarray:
    """A leaf's bytes, any dtype (bf16 included) and rank."""
    if isinstance(x, torch.Tensor):
        x = x.detach().contiguous()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        x = x.numpy()
    return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return np.asarray(x).dtype.name


def _same(a, b) -> bool:
    return (_dtype_name(a) == _dtype_name(b)
            and tuple(np.shape(a)) == tuple(np.shape(b))
            and np.array_equal(_bits(a), _bits(b)))


def _step_leaves(step_dir) -> dict:
    return {".".join(k for k, _ in p): v
            for p, v in flatten(read_step(step_dir)) if v is not None}


def _jax_leaves(state, epoch, rng) -> dict:
    """The checkpoint's leaves as ``restore_with_rng`` gives them."""
    tree = {"params": state.params, "opt_state": state.opt_state,
            "step": state.step, "epoch": np.asarray(epoch, np.int64)}
    if state.ema_params is not None:
        tree["ema_params"] = state.ema_params
    out = {_dotted(p): np.asarray(v)
           for p, v in jax.tree_util.tree_leaves_with_path(tree)}
    if rng is not None:
        out["rng_key"] = np.asarray(jax.random.key_data(rng)).ravel()
    return out


def _frozen(path) -> bool:
    last = _dotted(path[-1:])
    return last in ("fa_projection", "projection")


def _in_collection(path) -> bool:
    return any(getattr(k, "key", None) in ("moe_losses", "moe_metrics")
               for k in path)


def _seeded_opt_state(tx, params, count: int, seed: int):
    """``tx.init(params)`` with its counts at ``count`` and seeded moments
    (zero where training leaves them zero)."""
    rng = np.random.default_rng(seed)
    state = tx.init(params)

    def fill(path, leaf):
        leaf = np.asarray(leaf)
        if leaf.dtype.kind in "iu":
            return np.full_like(leaf, count)
        if _in_collection(path) or _frozen(path):
            return leaf
        draw = rng.standard_normal(leaf.shape)
        is_nu = any(getattr(k, "name", None) == "nu" for k in path)
        draw = 1e-6 * np.abs(draw) if is_nu else 1e-3 * draw
        return draw.astype(leaf.dtype)

    return jax.tree_util.tree_map_with_path(fill, state)


_INIT = {}


def _template(cfg):
    """A JAX ``TrainState`` of ``cfg`` to restore into: the model's init
    (once per model config) under ``cfg``'s optimizer and EMA."""
    key = cfg.model.to_json() if hasattr(cfg.model, "to_json") else repr(
        cfg.model)
    if key not in _INIT:
        _INIT[key] = JaxTrainer(cfg).init_state().params
    params = _INIT[key]
    tx = make_optimizer(cfg)
    ema = ({"params": params["params"]} if cfg.train.ema_decay > 0
           else None)
    return JaxTrainState(step=jnp.asarray(0, jnp.int32), params=params,
                         opt_state=tx.init(params), tx=tx, ema_params=ema)


def _jax_restore(run, cfg, step=None):
    return JaxCheckpointManager(os.path.join(run, "ckpt")).restore_with_rng(
        _template(cfg), step)


def _variant_cfg(train_kw):
    cfg = tiny_config(num_layers=1, latent_dim=32, ff_size=16,
                      num_random_features=16)
    return dataclasses.replace(
        cfg, name="variant",
        train=dataclasses.replace(cfg.train, batch_size=4,
                                  uncond_step=False, **train_kw))


# ---------------------------------------------------------------- fixtures

@pytest.fixture(scope="module")
def variants(tmp_path_factory):
    """name -> (run dir, JAX config, step): one step each, saved by the JAX
    ``CheckpointManager``."""
    root = tmp_path_factory.mktemp("variants")
    base_cfg = _variant_cfg({})
    params = perturb_zero_leaves(_template(base_cfg).params, seed=1)
    runs = {}
    for i, (name, (train_kw, key)) in enumerate(VARIANTS.items()):
        cfg = _variant_cfg(train_kw)
        run = str(root / name)
        os.makedirs(run)
        cfg.save(os.path.join(run, "config.json"))
        tx = make_optimizer(cfg)
        ema = None
        if cfg.train.ema_decay > 0:
            ema = {"params": jax.tree_util.tree_map(
                lambda p: p + np.float32(0.01), params["params"])}
        state = JaxTrainState(step=jnp.asarray(3, jnp.int32), params=params,
                              opt_state=_seeded_opt_state(tx, params, 3, i),
                              tx=tx, ema_params=ema)
        ckpt = JaxCheckpointManager(os.path.join(run, "ckpt"))
        ckpt.save(3, state, epoch=2, rng=jax.random.key(7) if key else None)
        ckpt.wait()
        runs[name] = (run, cfg, 3)
    return runs


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """The JAX -> port -> JAX run dir of both train CLIs (see the module
    doc); returns (run dir, JAX config, the port CLI's stdout, the JAX
    CLI's stdout)."""
    root = str(tmp_path_factory.mktemp("chain"))
    argv = CHAIN_FLAGS + ["--checkpoint_dir", root]
    cfg = jax_config_from_args(jax_train_args().parse_args(
        argv + ["--num_epochs", "4"]))
    run = os.path.join(root, cfg.name)
    os.makedirs(run)
    cfg.save(os.path.join(run, "config.json"))
    state = JaxTrainer(cfg).init_state()
    params = perturb_zero_leaves(state.params, seed=2)
    state = state.replace(
        params=params, step=jnp.asarray(3, jnp.int32),
        opt_state=_seeded_opt_state(state.tx, params, 3, 9),
        ema_params={"params": jax.tree_util.tree_map(
            lambda p: p - np.float32(0.02), params["params"])})
    ckpt = JaxCheckpointManager(os.path.join(run, "ckpt"))
    ckpt.save(3, state, epoch=3, rng=jax.random.key(11))
    ckpt.wait()
    port_out, jax_out = io.StringIO(), io.StringIO()
    with redirect_stdout(port_out):
        port_train_main(argv + ["--num_epochs", "4", "--device", "cpu"])
    with redirect_stdout(jax_out):
        jax_train_main(argv + ["--num_epochs", "5"])
    return run, cfg, port_out.getvalue(), jax_out.getvalue()


@pytest.fixture(scope="module")
def small_node_stores(tmp_path_factory):
    """OCDBT databases written by tensorstore with nodes small enough for a
    B+tree of height > 0: zstd nodes and uncompressed ones."""
    out = {}
    rng = np.random.default_rng(0)
    for name, comp in (("zstd", {"id": "zstd", "level": 3}),
                       ("uncompressed", None)):
        path = str(tmp_path_factory.mktemp(f"ocdbt_{name}"))
        kv = ts.KvStore.open({
            "driver": "ocdbt", "base": f"file://{path}/",
            "config": {"max_decoded_node_bytes": 512,
                       "max_inline_value_bytes": 16,
                       "compression": comp}}).result()
        with ts.Transaction() as txn:
            for i in range(300):
                kv.with_transaction(txn)[f"a/long/prefix/key{i:04d}/x"] = (
                    rng.bytes(int(rng.integers(1, 48))))
        out[name] = path
    return out


# ---------------------------------------------------------------- (a) zstd

@pytest.mark.parametrize("kind", ["content_size", "no_content_size",
                                  "streamed", "two_frames"])
def test_zstd_decodes_what_zstandard_encodes(kind):
    data = np.random.default_rng(3).bytes(5000) + b"abc" * 70000
    if kind == "content_size":
        frames = zstandard.ZstdCompressor(
            level=3, write_content_size=True).compress(data)
    elif kind == "no_content_size":
        frames = zstandard.ZstdCompressor(
            level=1, write_content_size=False).compress(data)
    elif kind == "streamed":
        c = zstandard.ZstdCompressor().compressobj()
        frames = c.compress(data) + c.flush()
    else:
        half = len(data) // 2
        c = zstandard.ZstdCompressor(write_content_size=False)
        frames = c.compress(data[:half]) + c.compress(data[half:])
    assert bytes(zstd.decompress(frames, len(data))) == data
    out = bytearray(len(data))
    assert zstd.decompress_into(memoryview(frames), out) == len(data)
    assert bytes(out) == data
    if kind != "two_frames":  # one frame's header sizes (or streams) it
        assert bytes(zstd.decompress(frames)) == data
    with pytest.raises(ValueError, match="zstd"):
        zstd.decompress(frames, len(data) - 1)
    assert zstd.version().count(".") == 2


# ----------------------------------------------------- (b) OCDBT reader

def _ocdbt_dirs(variants, chain, small_node_stores):
    run = chain[0]
    dirs = {f"variant_{n}": os.path.join(r, "ckpt", str(s), "default")
            for n, (r, _, s) in variants.items()}
    dirs["chain_jax_step3"] = os.path.join(run, "ckpt", "3", "default")
    dirs["chain_jax_step5"] = os.path.join(run, "ckpt", "5", "default")
    dirs["fixture"] = os.path.join(FIXTURE_RUN, "ckpt", "2", "default")
    dirs["fixture_process_0"] = os.path.join(dirs["fixture"],
                                             "ocdbt.process_0")
    dirs.update({f"tensorstore_{k}": v for k, v in small_node_stores.items()})
    return dirs


def test_ocdbt_reader_equals_tensorstore(variants, chain, small_node_stores):
    dirs = _ocdbt_dirs(variants, chain, small_node_stores)
    assert len(dirs) == len(VARIANTS) + 6
    for name, path in dirs.items():
        kv = ts.KvStore.open({"driver": "ocdbt",
                              "base": f"file://{path}/"}).result()
        want = sorted(k.decode() for k in kv.list().result())
        with ocdbt.OcdbtReader(path) as reader:
            assert reader.keys() == want, name
            for key in want:
                assert reader.read(key) == kv.read(key).result().value, (
                    name, key)
        if name.startswith("tensorstore"):
            assert len(want) == 300


# name -> (shape, chunks, zarr dtype, fill value, the chunk left out): edge
# chunks on every axis, and one chunk of the fill value, which tensorstore
# does not store
GRID_ARRAYS = {
    "f32_3d": ((5, 7, 4), (2, 3, 4), "<f4", -2.5, (1, 2, 0)),
    "bf16_2d": ((9, 10), (4, 4), "bfloat16", 1.1, (2, 0)),
    "i32_1d": ((11,), (4,), "<i4", None, None),
}


@pytest.mark.parametrize("compressor", [None, "zstd"], ids=["raw", "zstd"])
@pytest.mark.parametrize("kvstore", ["file", "ocdbt"])
def test_chunked_arrays_equal_tensorstore(tmp_path, kvstore, compressor):
    """zarr v2 arrays that tensorstore writes on a chunk grid (as a JAX run
    of several processes does), on files (the plain layout) and in one
    OCDBT database: each read equals tensorstore's bit for bit, a chunk left
    out reads as the fill value (bf16's rounded to its word)."""
    root = str(tmp_path)
    rng = np.random.default_rng(6)
    comp = None if compressor is None else {"id": "zstd", "level": 1}
    arrays = {}
    for name, (shape, chunks, dtype, fill, gap) in GRID_ARRAYS.items():
        kv = ({"driver": "file", "path": f"{root}/{name}/"}
              if kvstore == "file" else
              {"driver": "ocdbt", "base": f"file://{root}/",
               "path": f"{name}/"})
        arr = ts.open({"driver": "zarr", "kvstore": kv, "metadata": {
            "shape": list(shape), "chunks": list(chunks), "dtype": dtype,
            "fill_value": fill, "compressor": comp, "order": "C",
            "dimension_separator": "."}}, create=True).result()
        data = rng.standard_normal(shape) * 100
        data = data.astype(arr.dtype.numpy_dtype)
        if gap is not None:
            data[tuple(slice(i * c, (i + 1) * c)
                       for i, c in zip(gap, chunks))] = fill
        arr.write(data).result()
        # the fill value as written, not as tensorstore stores it back (a
        # bf16 one as its exact value): 1.1 must be rounded to its word
        kvs = ts.KvStore.open(kv).result()
        meta = json.loads(kvs.read(".zarray").result().value)
        meta["fill_value"] = fill
        kvs.write(".zarray", json.dumps(meta).encode()).result()
        arr = ts.open({"driver": "zarr", "kvstore": kv},
                      context=ts.Context()).result()
        arrays[name] = (arr, gap)
    store = orbax_format._store(root, kvstore == "ocdbt")
    try:
        keys = (store.keys() if kvstore == "ocdbt" else
                [os.path.relpath(os.path.join(d, f), root).replace(os.sep,
                                                                   "/")
                 for d, _, fs in os.walk(root) for f in fs])
        for name, (arr, gap) in arrays.items():
            shape, chunks = GRID_ARRAYS[name][:2]
            grid = [-(-s // c) for s, c in zip(shape, chunks)]
            stored = [k for k in keys if k.startswith(f"{name}/")
                      and not k.endswith(".zarray")]
            assert len(stored) == int(np.prod(grid)) - (gap is not None)
            if gap is not None:
                assert f"{name}/{'.'.join(map(str, gap))}" not in stored
            got = orbax_format.read_array(store, name)
            want = arr.read().result()
            assert tuple(got.shape) == shape, name
            assert np.array_equal(_bits(got), _bits(want)), name
    finally:
        if hasattr(store, "close"):
            store.close()


# ---------------------------------------- (c) leaves against JAX's restore

def test_decoded_leaves_equal_the_jax_restore(variants, chain):
    cases = [(r, cfg, s) for r, cfg, s in variants.values()]
    cases += [(chain[0], chain[1], 3), (chain[0], chain[1], 5)]
    for run, cfg, step in cases:
        state, epoch, rng = _jax_restore(run, cfg, step)
        want = _jax_leaves(state, epoch, rng)
        got = _step_leaves(os.path.join(run, "ckpt", str(step)))
        if rng is not None:
            width = int(got.pop("rng_width"))
            assert bool(got.pop("has_rng"))
            np.testing.assert_array_equal(got.pop("rng").numpy()[:width],
                                          want.pop("rng_key"))
        else:
            assert not bool(got.pop("has_rng"))
            got.pop("rng"), got.pop("rng_width")
        # the sidecar raises the epoch restore gives; the step stores its own
        got_epoch = int(got.pop("epoch"))
        assert int(want.pop("epoch")) >= got_epoch
        assert set(got) == set(want), (run, step)
        for k in want:
            assert _same(got[k], want[k]), (run, step, k)
        bf16 = [k for k, v in got.items() if v.dtype == torch.bfloat16]
        mu_bf16 = cfg.train.adam_mu_dtype == "bfloat16"
        assert bool(bf16) == mu_bf16 and all(".mu." in k or ".nu." in k
                                             for k in bf16)


def test_the_committed_fixture_equals_its_npz():
    npz = np.load(FIXTURE_RUN + ".npz")
    bf16 = set(npz["__bf16__"].tolist())
    got = _step_leaves(os.path.join(FIXTURE_RUN, "ckpt", "2"))
    assert set(got) == set(npz.files) - {"__bf16__"}
    for k, v in got.items():
        if k in bf16:
            assert v.dtype == torch.bfloat16, k
            np.testing.assert_array_equal(
                v.view(torch.int16).numpy().view(np.uint16), npz[k])
        else:
            assert _same(v, npz[k]), k
    assert bool(got["has_rng"]) and int(got["step"]) == 2
    assert int(got["opt_state.1.1.count"]) == int(got["opt_state.1.0.count"])


# ------------------------------------------------- (d) the port's forward

def test_moe_collections_carry_nothing_the_forward_reads(variants):
    run, cfg, step = variants["warmup_f32_ema_key"]
    state, _, _ = _jax_restore(run, cfg, step)
    assert set(state.params) == {"params", "moe_losses", "moe_metrics"}
    x, tt, n, ids = _inputs(cfg)
    model = JaxMotionTransformer(cfg.model)
    apply = jax.jit(lambda v: model.apply(v, x, tt, n, text_ids=ids))
    bent = jax.tree_util.tree_map(lambda a: a + 123.0, {
        k: v for k, v in state.params.items() if k != "params"})
    np.testing.assert_array_equal(
        np.asarray(apply({"params": state.params["params"]})),
        np.asarray(apply({"params": state.params["params"], **bent})))


def _inputs(cfg, B=3):
    rng = np.random.default_rng(4)
    T, F = cfg.model.max_frames, cfg.model.input_feats
    x = rng.standard_normal((B, T, F)).astype(np.float32)
    tt = np.array([5, 50, 90], np.int32)[:B]
    n = np.array([T, 11, 7], np.int32)[:B]
    ids = hash_tokenize(["a person walks", "jump", ""][:B],
                        cfg.model.text_max_tokens)
    return x, tt, n, ids


@pytest.mark.parametrize("use_ema", [False, True], ids=["params", "ema"])
def test_a_port_model_from_a_jax_run_gives_the_jax_forward(variants,
                                                           use_ema):
    run, cfg, step = variants["warmup_f32_ema_key"]
    state, _, _ = _jax_restore(run, cfg, step)
    weights = (state.ema_params if use_ema else state.params)["params"]
    x, tt, n, ids = _inputs(cfg)
    ref = JaxMotionTransformer(cfg.model).apply({"params": weights}, x, tt,
                                                n, text_ids=ids)
    pcfg, sd, got_step, normalizer = port_export.load_run(run,
                                                          use_ema=use_ema)
    assert got_step == step and normalizer is None
    model = MotionTransformer(pcfg.model)
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = model.eval()(t(x), t(tt).long(), t(n).long(),
                           text_ids=t(ids).long())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


# ------------------------------------------- (e) one resumed train step

def _jax_value_and_grad(cfg):
    model = JaxMotionTransformer(cfg.model)
    sched = JG.make_schedule(schedule_name=cfg.diffusion.beta_schedule,
                             num_timesteps=cfg.diffusion.num_timesteps)

    def loss(params, batch, noise):
        x0, tt = batch["motion"], batch["t"]
        x_t = JG.q_sample(sched, x0, tt, noise)
        out, cols = model.apply(
            {"params": params}, x_t, tt, batch["length"],
            text_ids=batch["text_ids"], deterministic=False,
            rngs={"dropout": jax.random.key(0),
                  "stochdepth": jax.random.key(1)},
            mutable=["moe_losses", "moe_metrics"])
        terms = JG.training_loss_terms(sched, out, x0, x_t, tt, noise)
        mask = jax_src_mask(x0.shape[1], batch["length"])
        rec = JL.masked_frame_mse(terms["pred"], terms["target"], mask,
                                  sample_weight=batch["t_weight"])
        return rec + jax_sum_aux(cols) * cfg.model.moe_aux_loss_weight

    return jax.jit(jax.value_and_grad(loss))


def test_one_resumed_step_equals_the_jax_step(variants):
    run, cfg, step = variants["warmup_f32_ema_key"]
    x, tt, n, ids = _inputs(cfg, B=2)
    batch = {"motion": x, "length": n, "text_ids": ids, "t": tt,
             "t_weight": np.array([1.0, 0.5], np.float32)}
    noise = np.random.default_rng(8).standard_normal(x.shape).astype(
        np.float32)
    # JAX: restore, one step of make_optimizer's chain
    state, _, _ = _jax_restore(run, cfg, step)
    jloss, g = _jax_value_and_grad(cfg)(
        state.params["params"], {k: jnp.asarray(v) for k, v in
                                 batch.items()}, jnp.asarray(noise))
    grads = {**jax.tree_util.tree_map(jnp.zeros_like, state.params),
             "params": g}
    upd, opt = state.tx.update(grads, state.opt_state, state.params)
    new_params = jax_to_state_dict(jax.device_get(
        optax.apply_updates(state.params, upd)["params"]))
    adam = jax.device_get(opt[1][0])
    # the port: the same checkpoint through its CheckpointManager
    pcfg = to_port(cfg)
    pstate = create_train_state(MotionTransformer(pcfg.model), pcfg)
    _, epoch, rng_state = CheckpointManager(
        os.path.join(run, "ckpt"), cfg=pcfg).restore_with_rng(pstate)
    assert rng_state is None and pstate.step == step
    assert pstate.optimizer.count == step
    sched = make_schedule(schedule_name=pcfg.diffusion.beta_schedule,
                          num_timesteps=pcfg.diffusion.num_timesteps)
    pbatch = {k: t(v).long() if k in ("length", "text_ids", "t") else t(v)
              for k, v in batch.items()}
    step_fn = TrainStep(sched, pcfg)
    metrics = step_fn.backward(pstate, pbatch, None, noise=t(noise))
    np.testing.assert_allclose(metrics["loss_total"].item(), float(jloss),
                               rtol=1e-5)
    step_fn.apply_update(pstate, metrics)
    assert pstate.step == step + 1
    assert pstate.optimizer.count == int(adam.count) == step + 1
    gsd = jax_to_state_dict(jax.device_get(g))
    mu = jax_to_state_dict(adam.mu["params"])
    nu = jax_to_state_dict(adam.nu["params"])
    trainable = [(name, p) for name, p in pstate.model.named_parameters()
                 if p.requires_grad]
    lr = pcfg.train.lr
    for (name, p), m, v in zip(trainable, pstate.optimizer.mu,
                               pstate.optimizer.nu):
        gr = gsd[name].numpy()
        tol_g = 1e-4 * np.abs(gr).max() + 1e-7
        err = np.abs(p.detach().numpy() - new_params[name].numpy())
        assert (err[np.abs(gr) >= 1e-6] <= 2e-6).all(), name
        assert (err <= 2 * lr).all(), name
        mj, vj = mu[name].numpy(), nu[name].numpy()
        assert np.abs(m.numpy() - mj).max() <= (
            (1 - B1) * tol_g + 1e-6 * np.abs(mj).max()), name
        assert np.abs(v.numpy() - vj).max() <= (
            (1 - B2) * (2 * np.abs(gr).max() * tol_g + tol_g ** 2)
            + 1e-6 * np.abs(vj).max()), name


# ------------------------------ (f) the JAX layout, restored and resumed

@pytest.mark.parametrize("name", ["warmup_mu_bf16_ema_key",
                                  "cosine_compact_noema_nokey",
                                  "constant_f32_noema_nokey"])
def test_the_port_writes_what_the_jax_restore_reads_bit_for_bit(
        variants, tmp_path, name):
    """A JAX step read into a port state and saved again in the JAX layout:
    the JAX ``CheckpointManager`` restores every leaf of the original,
    the sown collections and the frozen moments included; the generator's
    sidecar is ignored there and read back here. A constant learning rate
    leaves the schedule's state empty (``opt_state.1.1``) in both."""
    run, cfg, step = variants[name]
    pcfg = to_port(cfg)
    src = CheckpointManager(os.path.join(run, "ckpt"), cfg=pcfg)
    state = create_train_state(MotionTransformer(pcfg.model), pcfg)
    _, epoch, _ = src.restore_with_rng(state)
    assert state.step == step and state.optimizer.count == step
    out = str(tmp_path / "run")
    shutil.copytree(run, out, ignore=shutil.ignore_patterns("ckpt"))
    dst = CheckpointManager(os.path.join(out, "ckpt"), fmt="orbax", cfg=pcfg)
    dst._extras = src._extras
    gen = torch.Generator().manual_seed(5)
    dst.save(step, state, epoch, gen)
    names = sorted(os.listdir(os.path.join(out, "ckpt")))
    assert names == [str(step)]   # no temporary directory is left
    want = _jax_leaves(*_jax_restore(run, cfg, step))
    got = _jax_leaves(*_jax_restore(out, cfg, step))
    want.pop("rng_key", None)
    assert "rng_key" not in got   # the port saves has_rng=False
    assert set(got) == set(want)
    for k in want:
        assert _same(got[k], want[k]), k
    back = CheckpointManager(os.path.join(out, "ckpt"), cfg=pcfg).read()
    assert torch.equal(back["rng"], gen.get_state())
    assert back["opt_state"]["count"] == step
    has_schedule = cfg.train.lr_schedule != "constant" or (
        cfg.train.lr_warmup_steps > 0)
    assert (read_step(os.path.join(out, "ckpt", str(step)))["opt_state"][1][1]
            is not None) == has_schedule


def test_a_fresh_port_state_saved_in_the_jax_layout_restores_in_jax(
        tmp_path):
    cfg = _variant_cfg(VARIANTS["warmup_mu_bf16_ema_key"][0])
    pcfg = to_port(cfg)
    state = Trainer(pcfg, device="cpu").init_state()
    ckpt = CheckpointManager(str(tmp_path / "ckpt"), fmt="orbax", cfg=pcfg,
                             max_to_keep=2)
    for step in (1, 2, 3):
        state.step = step
        ckpt.save(step, state, 0)
    ckpt.save(3, state, 9)  # a step saved already is skipped
    assert ckpt.all_steps() == [2, 3]
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["2", "3"]
    jstate, epoch, rng = _jax_restore(str(tmp_path), cfg)
    assert int(jstate.step) == 3 and epoch == 0 and rng is None
    sd = jax_to_state_dict(jax.device_get(jstate.params["params"]))
    for name, p in state.model.named_parameters():
        assert _same(sd[name], p.detach()), name
    coll = jax.device_get(jstate.params["moe_losses"])
    assert all(not np.asarray(v).any()
               for v in jax.tree_util.tree_leaves(coll))


def test_the_train_clis_resume_each_others_runs(chain):
    run, cfg, port_out, jax_out = chain
    seed = resume_seed(cfg.train.seed, 3)
    assert f"generator seeded with {seed}" in port_out
    assert "[trainer] resumed from step 3 (epoch 3)" in port_out
    assert "[trainer] resumed from step 4 (epoch 4)" in jax_out
    ckpt = os.path.join(run, "ckpt")
    steps = sorted(n for n in os.listdir(ckpt) if n.isdigit())
    assert steps == ["3", "4", "5"]
    meta = lambda s: open(os.path.join(ckpt, s, "default",  # noqa: E731
                                       "_METADATA")).read()
    assert '"use_ocdbt": false' in meta("4")   # the port's
    assert '"use_ocdbt": true' in meta("5")    # the JAX package's again
    payload = CheckpointManager(ckpt, cfg=to_port(cfg)).read(5)
    assert payload["step"] == 5 and payload["opt_state"]["count"] == 5
    assert payload["rng"] is None and "ema_params" in payload
    assert payload["opt_state"]["mu"][0].dtype == torch.bfloat16


# --------------------------------------- (g) export, (h) the other CLIs

@pytest.mark.parametrize("use_ema", [False, True], ids=["params", "ema"])
def test_export_of_a_jax_run_equals_the_jax_export(variants, tmp_path,
                                                   use_ema):
    run = variants["warmup_mu_bf16_ema_key"][0]
    ours = port_export.export_run(run, str(tmp_path / "port"),
                                  use_ema=use_ema)
    theirs = jax_export_run(run, str(tmp_path / "jax"), use_ema=use_ema)
    with open(os.path.join(ours, "params.msgpack"), "rb") as f:
        a = fser.msgpack_restore(f.read())
    with open(os.path.join(theirs, "params.msgpack"), "rb") as f:
        b = fser.msgpack_restore(f.read())
    la = {_dotted(p): v for p, v in jax.tree_util.tree_leaves_with_path(a)}
    lb = {_dotted(p): v for p, v in jax.tree_util.tree_leaves_with_path(b)}
    # the JAX export keeps the sown collections of the live state
    lb = {k: v for k, v in lb.items() if k.startswith("params.")}
    assert set(la) == set(lb)
    for k in lb:
        assert _same(la[k], lb[k]), k


@pytest.mark.parametrize("tool", ["serve", "evaluate", "visualize"])
def test_the_cli_tools_take_a_jax_run_dir(chain, tool, tmp_path, capsys):
    """The chain's run dir, whose newest step the JAX CLI wrote."""
    run = chain[0]
    if tool == "serve":
        from tests.test_torch_export import _post, _serve
        srv, url = _serve(["--run_dir", run, "--use_ema"])
        try:
            body = _post(url + "/generate", {"texts": ["a person waves"],
                                             "lengths": [12]})
        finally:
            srv.shutdown()
            srv.server_close()
        assert body["shapes"] == [[12, chain[1].data.dim_pose]]
        assert np.isfinite(np.asarray(body["motions"][0])).all()
    elif tool == "evaluate":
        from motiondiffusion_moe_tpu_torch.tools.evaluate import main
        from tests.test_torch_evaluate_cli import PROTOCOL
        res = main(PROTOCOL + ["--run_dir", run, "--dataset", "synthetic",
                               "--max_samples", "8", "--replication_times",
                               "1", "--skip_joint_scores", "--use_ema",
                               "--log_file", str(tmp_path / "e.log")])
        assert res["summary"]
    else:
        from motiondiffusion_moe_tpu_torch.tools.visualize import main
        joints = main(["--run_dir", run, "--text", "a person walks",
                       "--motion_length", "8", "--sampler", "ddim",
                       "--steps", "2", "--result_path",
                       str(tmp_path / "m.gif"), "--device", "cpu"])
        assert np.isfinite(joints).all()
    assert "step 5" in capsys.readouterr().out


# ------------------------------------------------------------ (i) errors

def test_errors_name_their_cause(variants, tmp_path, monkeypatch):
    run = variants["constant_f32_noema_nokey"][0]
    step_dir = os.path.join(run, "ckpt", "3")
    # a manifest whose bytes changed
    bad = str(tmp_path / "bad")
    shutil.copytree(os.path.join(step_dir, "default"), bad)
    with open(os.path.join(bad, "manifest.ocdbt"), "r+b") as f:
        f.seek(20)
        byte = f.read(1)
        f.seek(20)
        f.write(bytes([byte[0] ^ 0xFF]))
    with pytest.raises(ValueError, match="CRC-32C"):
        ocdbt.OcdbtReader(bad)
    with open(os.path.join(bad, "manifest.ocdbt"), "r+b") as f:
        f.write(b"\0\0\0\0")
    with pytest.raises(ValueError, match="bad magic"):
        ocdbt.OcdbtReader(bad)
    # a chunk missing from a plain-layout step
    plain = str(tmp_path / "plain" / "7")
    write_step(plain, {"a": torch.arange(6.0).reshape(2, 3), "s": None})
    assert _step_leaves(plain).keys() == {"a"}
    os.unlink(os.path.join(plain, "default", "a", "0.0"))
    with pytest.raises(ValueError, match="chunk a/0.0 is missing"):
        read_step(plain)
    with pytest.raises(FileExistsError):
        write_step(plain, {"a": torch.zeros(1)})
    # a directory holding both formats
    both = str(tmp_path / "both")
    shutil.copytree(os.path.join(run, "ckpt"), both)
    open(os.path.join(both, "step_3.pt"), "wb").close()
    with pytest.raises(ValueError, match="both a JAX run's orbax steps"):
        CheckpointManager(both)
    with pytest.raises(ValueError, match="holds orbax checkpoints"):
        CheckpointManager(os.path.join(run, "ckpt"), fmt="torch")
    # no libzstd on the system
    monkeypatch.setattr(zstd, "_lib", None)
    monkeypatch.setattr(zstd, "_candidates", lambda: iter(()))
    with pytest.raises(RuntimeError, match="libzstd.so.1.*tools/export.py"):
        read_step(step_dir)
