"""The port's own config, and that the port imports nothing of JAX.

``motiondiffusion_moe_tpu_torch/config.py`` is a copy of the JAX package's
config: the presets must give the same dictionaries, and a ``config.json``
written by either package must load equal in the other. The port, every
submodule of it, and ``chip_smoke.py`` must import neither ``jax``,
``flax``, ``msgpack``, ``ml_dtypes``, ``tensorstore``, ``orbax``,
``zstandard`` (the card's machine has none of them) nor anything of
``motiondiffusion_moe_tpu``.
"""

import ast
import inspect
import os
import subprocess
import sys

import pytest

from motiondiffusion_moe_tpu import config as jax_config
from motiondiffusion_moe_tpu_torch import config as port_config
from motiondiffusion_moe_tpu_torch.pipeline import GenerationPipeline

from tests._torch_parity import tiny_config, to_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "motiondiffusion_moe_tpu", "msgpack",
             "ml_dtypes", "tensorstore", "orbax", "zstandard")
# modules the fresh-interpreter import must reach (the eval slice, the MoE
# computes, the tools and utilities among them)
NEEDED = tuple("motiondiffusion_moe_tpu_torch." + m for m in (
    "diffusion.guidance", "diffusion.sampling", "eval", "eval.metrics",
    "eval.word_vectorizer", "eval.evaluator_models", "eval.protocol",
    "models.evaluator_bridge", "tools.evaluate", "pipeline",
    "models.deberta", "models.moe", "tools.visualize",
    "tools.serving_quality", "tools.profile_bench", "tools.bench_loader",
    "tools.soak_report", "utils.plot", "utils.media", "utils.profiling",
    "utils.debugging", "utils.bench_init", "utils.zstd", "utils.ocdbt",
    "utils.orbax_format", "training.checkpoint", "parallel",
    "parallel.distributed", "parallel.data_parallel"))


@pytest.mark.parametrize("preset", ["small_dense", "moe_small", "moe_big"])
def test_presets_match_the_jax_config(preset, tmp_path):
    ours = getattr(port_config.ExperimentConfig, preset)()
    theirs = getattr(jax_config.ExperimentConfig, preset)()
    assert ours.to_dict() == theirs.to_dict()
    assert ours.to_json() == theirs.to_json()
    # a config.json written by one package loads equal in the other
    a, b = tmp_path / "port.json", tmp_path / "jax.json"
    ours.save(str(a))
    theirs.save(str(b))
    assert jax_config.ExperimentConfig.load(str(a)) == theirs
    assert port_config.ExperimentConfig.load(str(b)) == ours


def test_to_port_gives_the_ports_own_objects():
    cfg = tiny_config(use_fast_xattn=True)
    ported = to_port(cfg)
    assert isinstance(ported, port_config.ExperimentConfig)
    assert isinstance(ported.model, port_config.ModelConfig)
    assert ported.to_dict() == cfg.to_dict()
    assert to_port(cfg.model) == ported.model


def test_port_imports_nothing_of_jax():
    """A fresh interpreter imports the port and every submodule of it."""
    code = f"""
import importlib, pkgutil, sys
import motiondiffusion_moe_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r})
missing = [m for m in {NEEDED!r} if m not in names]
print("IMPORTED", len(names), "LOADED", bad, "MISSING", missing)
sys.exit(1 if bad or missing or len(names) < 30 else 0)
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout


def test_chip_smoke_imports_nothing_of_jax():
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    modules = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            modules += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            modules.append(node.module)
    assert "motiondiffusion_moe_tpu_torch.config" in modules
    assert not [m for m in modules if m.split(".")[0] in FORBIDDEN]


def test_generation_pipeline_runs_on_the_card_by_default():
    params = inspect.signature(GenerationPipeline).parameters
    assert params["device"].default == "cuda"
