"""The port's package exports and host utilities against the JAX package's.

- Exports: every name the JAX package's ``models``, ``training`` and
  ``utils`` export is importable from the port's, or is one of the names
  listed here with the reason it has no counterpart. Importing
  ``models`` loads neither DeBERTa nor ``transformers`` (the JAX package's
  does not either), nor matplotlib.
- ``utils/media.py`` and ``plot.motion_temporal_filter``: bit for bit
  against the JAX modules (the port keeps its own copies).
  ``plot.plot_3d_motion`` (PIL alone): its projection and its pixels
  against the JAX package's matplotlib figure and GIF.
- ``StepTimer``, ``checked`` / ``check_finite`` and ``assert_finite_tree``:
  the behaviour ``tests/test_utils.py`` pins for the JAX package, plus what
  the port does otherwise (the timer waits on the card's stream; checks
  stay on the device until the wrapper returns).
- ``utils/bench_init.py``: the JAX rule picks the same leaves (ones, zeros,
  normals with the flax fan-in) through the bridge.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import motiondiffusion_moe_tpu.models as jax_models
import motiondiffusion_moe_tpu.training as jax_training
import motiondiffusion_moe_tpu.utils as jax_utils
from motiondiffusion_moe_tpu.models.transformer import (
    MotionTransformer as JaxMotionTransformer,
)
from motiondiffusion_moe_tpu.utils import media as jax_media
from motiondiffusion_moe_tpu.utils.bench_init import (
    random_benchmark_params as jax_bench_params,
)
from motiondiffusion_moe_tpu.utils.debugging import (
    assert_finite_tree as jax_assert_finite_tree,
)
from motiondiffusion_moe_tpu.utils.plot import (
    motion_temporal_filter as jax_filter,
)
from motiondiffusion_moe_tpu_torch.models.bridge import jax_to_state_dict
from motiondiffusion_moe_tpu_torch.models.text_encoder import hash_tokenize
from motiondiffusion_moe_tpu_torch.models.transformer import MotionTransformer
from motiondiffusion_moe_tpu_torch.utils import (
    StepTimer,
    annotate,
    assert_finite_tree,
    check_finite,
    checked,
    enable_nan_debugging,
    media,
)
from motiondiffusion_moe_tpu_torch.utils.bench_init import (
    random_benchmark_params,
)
from motiondiffusion_moe_tpu_torch.utils.plot import motion_temporal_filter

from tests._torch_parity import tiny_model_config, to_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# JAX exports with no port counterpart, and why
NOT_PORTED = {
    "motiondiffusion_moe_tpu.models": {
        "stack_block_params": "scan_blocks layout: not to port",
        "unstack_block_params": "scan_blocks layout: not to port",
    },
    "motiondiffusion_moe_tpu.training": {
        "select_params": "the --use_ema choice is tools/export.py::load_run",
        "make_train_step": "the port's train step is the class TrainStep",
    },
    "motiondiffusion_moe_tpu.utils": {
        "enable_compilation_cache": "XLA's compilation cache: not to port",
    },
}


def _exports(module):
    return {n for n, v in vars(module).items()
            if not n.startswith("_") and not isinstance(v, type(sys))}


@pytest.mark.parametrize("jax_module", [jax_models, jax_training, jax_utils])
def test_port_exports_every_jax_name(jax_module):
    import importlib

    port = importlib.import_module(jax_module.__name__.replace(
        "motiondiffusion_moe_tpu", "motiondiffusion_moe_tpu_torch", 1))
    skip = NOT_PORTED[jax_module.__name__]
    want = _exports(jax_module) - {"annotations"}
    assert skip.keys() <= want  # the listed names are real JAX exports
    missing = sorted(n for n in want - skip.keys() if not hasattr(port, n))
    assert missing == []
    assert not any(hasattr(port, n) for n in skip)


def test_exports_import_in_a_fresh_interpreter_without_heavy_modules():
    code = """
import sys
from motiondiffusion_moe_tpu_torch.training import Trainer
from motiondiffusion_moe_tpu_torch.models import MotionTransformer
from motiondiffusion_moe_tpu_torch.utils import MetricsLogger
heavy = sorted(m for m in sys.modules if m.split(".")[0] in
               ("transformers", "matplotlib", "jax", "flax")
               or m.endswith("models.deberta"))
print("HEAVY", heavy)
sys.exit(1 if heavy else 0)
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ---------------------------------------------------------------- media, plot

def _frames(n=3, h=20, w=24, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
            for _ in range(n)]


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_media_matches_jax_bit_for_bit(tmp_path):
    frames = _frames(4)
    ours, theirs = tmp_path / "o", tmp_path / "t"
    media.compose_gif_img_list(frames, str(tmp_path / "o.gif"), 50)
    jax_media.compose_gif_img_list(frames, str(tmp_path / "t.gif"), 50)
    assert _bytes(tmp_path / "o.gif") == _bytes(tmp_path / "t.gif")
    visuals = {"real": frames[0], "fake": frames[1]}
    media.save_images(visuals, str(ours))
    jax_media.save_images(visuals, str(theirs))
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs)) == [
        "0_real.jpg", "1_fake.jpg"]
    for name in os.listdir(ours):
        assert _bytes(ours / name) == _bytes(theirs / name)
    grid = media.compose_image(frames, 2, 2, (24, 20))
    np.testing.assert_array_equal(
        np.asarray(grid), np.asarray(jax_media.compose_image(
            frames, 2, 2, (24, 20))))
    media.compose_and_save_img(frames, str(ours), "g.png", 4, 1, (24, 20))
    jax_media.compose_and_save_img(frames, str(theirs), "g.png", 4, 1,
                                   (24, 20))
    assert _bytes(ours / "g.png") == _bytes(theirs / "g.png")
    ll = list(np.random.default_rng(1).random(11))
    for k in (1, 3, 4):
        assert media.list_cut_average(ll, k) == jax_media.list_cut_average(
            ll, k)


@pytest.mark.parametrize("sigma", [1.0, 2.5])
def test_motion_temporal_filter_matches_jax_bit_for_bit(sigma):
    joints = np.random.default_rng(2).standard_normal((30, 22, 3)).astype(
        np.float32)
    out = motion_temporal_filter(joints, sigma=sigma)
    assert out.shape == joints.shape
    np.testing.assert_array_equal(out, jax_filter(joints, sigma=sigma))


def test_pil_figure_projects_as_matplotlib_does():
    """The PIL backend's camera is matplotlib's: the same projection matrix
    as ``Axes3D.get_proj`` at the reference's view and limits, and the same
    pixel of every point."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from mpl_toolkits.mplot3d import proj3d

    from motiondiffusion_moe_tpu_torch.utils import plot

    fig = plt.figure(figsize=(10, 10))
    ax = fig.add_subplot(111, projection="3d")
    r = 4.0
    ax.set_xlim3d([-r / 2, r / 2])
    ax.set_ylim3d([0, r])
    ax.set_zlim3d([0, r])
    ax.view_init(elev=120, azim=-90)
    fig.canvas.draw()
    M = ax.get_proj()
    np.testing.assert_allclose(plot.view_projection(r), M, atol=1e-12)
    pts = np.random.default_rng(0).uniform(-2, 4, (50, 3))
    xs, ys, _ = proj3d.proj_transform(pts[:, 0], pts[:, 1], pts[:, 2], M)
    pix = ax.transData.transform(np.stack([xs, ys], 1))
    pix[:, 1] = 1000 - pix[:, 1]
    np.testing.assert_allclose(plot.project(pts, M, (1000, 1000)), pix,
                               atol=1e-6)
    plt.close(fig)


@pytest.mark.parametrize("with_title", [True, False])
def test_plot_writes_one_frame_per_motion_frame(with_title, tmp_path):
    """The GIF holds one 50 ms frame per motion frame at the figure's size,
    with the title drawn above the figure or nothing there."""
    from PIL import Image, ImageSequence

    from motiondiffusion_moe_tpu_torch.motion import T2M_KINEMATIC_CHAIN
    from motiondiffusion_moe_tpu_torch.utils import plot

    joints = np.cumsum(np.random.default_rng(3).standard_normal(
        (6, 22, 3)) * 0.05, 0) + np.array([0.0, 1.0, 0.0])
    gif = str(tmp_path / "m.gif")
    plot.plot_3d_motion(gif, T2M_KINEMATIC_CHAIN, joints,
                        title="walk" if with_title else "")
    with Image.open(gif) as im:
        assert im.size == (1000, 1000)
        assert [f.info["duration"] for f in ImageSequence.Iterator(im)] == [
            50] * 6
        top = np.asarray(im.convert("RGB"))[:100]
    assert (top.min(-1) < 128).any() == with_title


def _gif_frames(path):
    from PIL import Image, ImageSequence

    with Image.open(path) as im:
        return [np.asarray(f.convert("RGB")).astype(int)
                for f in ImageSequence.Iterator(im)]


def test_plot_pixels_match_jax_matplotlib_gif(tmp_path):
    """The PIL figure against the JAX package's matplotlib GIF of the same
    walking body: frame for frame, every drawn pixel (and every red and
    every blue one) lies within 2 px (3 px by colour) of one that
    matplotlib drew, and the other way round, for at least 98 % of them
    (matplotlib antialiases and lays the floor over the feet; PIL does
    neither); the title's box within 2 px."""
    from scipy.ndimage import binary_dilation

    from motiondiffusion_moe_tpu.utils.plot import (
        plot_3d_motion as jax_plot_3d_motion)
    from motiondiffusion_moe_tpu_torch.motion import (
        T2M_KINEMATIC_CHAIN, T2M_RAW_OFFSETS)
    from motiondiffusion_moe_tpu_torch.utils import plot

    rest = np.zeros((22, 3))
    for chain in T2M_KINEMATIC_CHAIN:
        for a, b in zip(chain[:-1], chain[1:]):
            rest[b] = rest[a] + 0.25 * T2M_RAW_OFFSETS[b]
    T = 6
    joints = rest[None] + np.array([0.0, 1.0, 0.0]) + np.cumsum(
        np.random.default_rng(4).standard_normal((T, 22, 3)) * 0.02, 0)
    joints[:, :, 0] += np.linspace(0, 0.3, T)[:, None]
    joints[:, :, 2] += np.linspace(0, 0.5, T)[:, None]
    ours, ref = str(tmp_path / "pil.gif"), str(tmp_path / "mpl.gif")
    plot.plot_3d_motion(ours, T2M_KINEMATIC_CHAIN, joints, title="walk")
    jax_plot_3d_motion(ref, T2M_KINEMATIC_CHAIN, joints, title="walk")
    P, R = _gif_frames(ours), _gif_frames(ref)
    assert len(P) == len(R) == T

    def near(a, b, px):  # share of a's pixels within px of one of b's
        return (a & binary_dilation(b, iterations=px)).sum() / a.sum()

    def masks(im):
        r, g, b = im[100:, :, 0], im[100:, :, 1], im[100:, :, 2]
        return {"ink": (im[100:].min(-1) < 128, 2),
                "red": ((r > g + 60) & (r > b + 60), 3),
                "blue": ((b > r + 60) & (b > g + 60), 3)}

    for k, (p, r) in enumerate(zip(P, R)):
        mp, mr = masks(p), masks(r)
        for name, (a, px) in mp.items():
            b = mr[name][0]
            assert a.sum() and b.sum(), (k, name)
            assert near(a, b, px) >= 0.98 and near(b, a, px) >= 0.98, (
                k, name, near(a, b, px), near(b, a, px))
        tp = np.argwhere(p[:100].min(-1) < 128)
        tr = np.argwhere(r[:100].min(-1) < 128)
        np.testing.assert_allclose(tp.min(0), tr.min(0), atol=2)
        np.testing.assert_allclose(tp.max(0), tr.max(0), atol=2)


# ---------------------------------------------------------------- profiling

def test_step_timer_percentiles_and_warmup():
    t = StepTimer(warmup=1)
    for _ in range(5):
        with t:
            _ = sum(range(1000))
    s = t.summary()
    assert s["steps"] == 4
    assert s["p95_s"] >= s["p50_s"] >= 0
    assert StepTimer().summary() == {"steps": 0}


@pytest.mark.parametrize("on_card", [True, False])
def test_step_timer_waits_on_the_cards_stream(on_card, monkeypatch):
    """With CUDA in use each step ends with a synchronisation of the
    current stream (the JAX timer waits on nothing); on the CPU none."""
    synced = []

    class Stream:
        def synchronize(self):
            synced.append(1)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: on_card)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: on_card)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: Stream())
    t = StepTimer(warmup=0)
    for _ in range(3):
        with t:
            pass
    assert synced == [1] * (3 if on_card else 0)
    assert t.summary()["steps"] == 3


def test_annotate_runs():
    with annotate("test_region"):
        _ = torch.ones(3) + 1


# ---------------------------------------------------------------- debugging

def test_checked_passes_finite():
    @checked
    def f(x):
        check_finite(x, "x")
        return x * 2

    np.testing.assert_allclose(f(torch.ones(3)).numpy(), 2.0)


def test_checked_raises_on_nan_naming_the_checks_that_fired():
    @checked
    def f(x):
        y = torch.log(x)  # NaN for negative x
        check_finite(x, "x")
        check_finite(y, "log(x)")
        check_finite(torch.ones(1), "one")
        return y

    with pytest.raises(FloatingPointError, match="non-finite") as err:
        f(torch.tensor([-1.0]))
    assert "log(x)" in str(err.value)
    assert "non-finite x " not in str(err.value)
    assert "one" not in str(err.value)


def test_checks_stay_on_the_device_until_the_wrapper_returns(monkeypatch):
    """Inside ``checked`` a check reads nothing back: the flag is read once,
    after the function returned."""
    order = []

    @checked
    def f(x):
        check_finite(x, "x")
        order.append("body done")
        return x

    real = torch.Tensor.tolist
    monkeypatch.setattr(torch.Tensor, "tolist",
                        lambda self: order.append("read") or real(self))
    monkeypatch.setattr(torch.Tensor, "__bool__",
                        lambda self: pytest.fail("host sync in a check"))
    f(torch.ones(3))
    assert order == ["body done", "read"]


def test_nested_checked_and_a_check_outside_one():
    @checked
    def inner(x):
        check_finite(x, "inner")
        return x

    @checked
    def outer(x):
        check_finite(x, "outer")
        return inner(x)

    with pytest.raises(FloatingPointError, match="non-finite inner"):
        outer(torch.tensor([float("inf")]))
    check_finite(torch.ones(2), "eager")
    with pytest.raises(FloatingPointError, match="non-finite eager"):
        check_finite(torch.tensor([float("nan")]), "eager")


def test_enable_nan_debugging_toggles_anomaly_mode():
    try:
        enable_nan_debugging()
        assert torch.is_anomaly_enabled()
    finally:
        enable_nan_debugging(False)
    assert not torch.is_anomaly_enabled()


def test_assert_finite_tree_gives_the_jax_message():
    good = {"a": np.ones(3), "b": {"c": torch.zeros(2)}, "n": torch.arange(3)}
    assert_finite_tree(good)
    bad = {"a": np.ones(3), "b": {"c": np.asarray([1.0, np.nan])}}
    with pytest.raises(FloatingPointError, match="b.*c"):
        assert_finite_tree(bad, "params")
    many = {"w": [np.full(2, np.inf) for _ in range(12)],
            "t": (np.ones(1), np.asarray([np.nan]))}
    for tree in (bad, many):
        with pytest.raises(FloatingPointError) as ours:
            assert_finite_tree(tree, "batch")
        with pytest.raises(FloatingPointError) as theirs:
            jax_assert_finite_tree(tree, "batch")
        assert str(ours.value) == str(theirs.value)
    assert "(+3 more)" in str(ours.value)
    torch_bad = {"x": torch.tensor([0.0, float("-inf")])}
    with pytest.raises(FloatingPointError, match=r"\['x'\]"):
        assert_finite_tree(torch_bad)


# ---------------------------------------------------------------- bench_init

def test_bench_init_picks_the_leaves_the_jax_rule_picks():
    cfg = tiny_model_config(num_layers=1)
    T, F = cfg.max_frames, cfg.input_feats
    ids = hash_tokenize(["a person walks"], cfg.text_max_tokens)
    shapes = jax.eval_shape(lambda: JaxMotionTransformer(cfg).init(
        jax.random.key(0), np.zeros((1, T, F), np.float32),
        np.zeros(1, np.int32), np.full(1, T, np.int32), text_ids=ids))
    ref = jax_to_state_dict(jax.device_get(jax_bench_params(shapes)))
    model = random_benchmark_params(MotionTransformer(to_port(cfg)), seed=3)
    sd = model.state_dict()
    assert sd.keys() == ref.keys()
    normals = 0
    for name, t in sd.items():
        r = ref[name].numpy()
        t = t.numpy()
        if (r == 1).all() or not r.any():
            np.testing.assert_array_equal(t, r, err_msg=name)
            continue
        normals += 1
        assert not (t == r).all(), name  # another stream, same law
        if r.size >= 2000:  # the same std: 1 / sqrt(flax fan-in)
            assert abs(t.std() / r.std() - 1) < 0.1, name
    assert normals > 20
    again = random_benchmark_params(MotionTransformer(to_port(cfg)), seed=3)
    assert all(torch.equal(a, b) for a, b in zip(
        sd.values(), again.state_dict().values()))
